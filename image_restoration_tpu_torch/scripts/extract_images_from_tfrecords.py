"""Extract FFHQ / CelebA images from TFRecords, without TensorFlow.

The port's own copy of the root script
`scripts/data_preparation/extract_images_from_tfrecords.py`: TFRecord
framing (a length, its masked CRC, the payload, its CRC) and the
`tf.train.Example` protobuf are read by a minimal protobuf wire-format
reader (`_read_varint` :28, `parse_message` :40, `parse_example` :66,
`iter_tfrecord` :91); the records carry an int64 `shape` and a bytes
`data` feature. CRCs are not verified (a corrupt record surfaces as a
reshape error). `convert_ffhq_tfrecords` :107 (CHW RGB records) and
`convert_celeba_tfrecords` :147 (HWC) write PNGs to a folder or an lmdb
(with its meta_info.txt) through the port's `utils/lmdb_util.py`.

    python -m image_restoration_tpu_torch.scripts.extract_images_from_tfrecords \\
        --dataset ffhq --tf_pattern 'ffhq/*.tfrecords' --log_resolution 8 \\
        --save_root datasets/ffhq [--save_type lmdb]
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import struct

import cv2
import numpy as np


# ---------------------------------------------------- protobuf wire reader

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf):
    """bytes → {field_number: [value, ...]} (values: int for varint,
    bytes for length-delimited)."""
    fields = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:        # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:      # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:      # 32-bit
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wire == 1:      # 64-bit
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def parse_example(record):
    """tf.train.Example bytes → {name: list of ints | list of bytes}."""
    example = parse_message(record)
    features = parse_message(example[1][0])       # Example.features = 1
    out = {}
    for entry in features.get(1, []):             # Features.feature map = 1
        kv = parse_message(entry)
        name = kv[1][0].decode("utf-8")           # map key = 1
        feat = parse_message(kv[2][0])            # map value (Feature) = 2
        if 1 in feat:                             # bytes_list
            out[name] = parse_message(feat[1][0]).get(1, [])
        elif 3 in feat:                           # int64_list
            vals = []
            for v in parse_message(feat[3][0]).get(1, []):
                if isinstance(v, bytes):          # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        vals.append(x)
                else:
                    vals.append(v)
            out[name] = vals
    return out


def iter_tfrecord(path):
    """Yield raw record bytes from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # masked crc of length (unverified)
            data = f.read(length)
            f.read(4)  # masked crc of data (unverified)
            yield data


# ------------------------------------------------------------- converters

def convert_ffhq_tfrecords(tf_pattern, log_resolution, save_root,
                           save_type="img", compress_level=1):
    """FFHQ records store CHW uint8 under 'data' with 'shape' (c,h,w)."""
    res = 2 ** log_resolution
    if save_type == "lmdb":
        from ..utils.lmdb_util import LmdbWriter
        save_path = osp.join(save_root, f"ffhq_{res}.lmdb")
        writer = LmdbWriter(save_path)
    else:
        save_path = osp.join(save_root, f"ffhq_{res}")
        os.makedirs(save_path, exist_ok=True)
    idx = 0
    meta = []
    for tf_file in sorted(glob.glob(tf_pattern)):
        print(f"reading {tf_file}")
        for record in iter_tfrecord(tf_file):
            feats = parse_example(record)
            c, h, w = feats["shape"]
            img = np.frombuffer(feats["data"][0],
                                np.uint8).reshape(c, h, w)
            img = img.transpose(1, 2, 0)[:, :, ::-1]  # CHW RGB → HWC BGR
            if save_type == "lmdb":
                ok, buf = cv2.imencode(
                    ".png", img,
                    [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
                key = f"{idx:08d}/r{log_resolution:02d}"
                writer.put(key, buf.tobytes())
                meta.append(f"{key}.png ({h},{w},{c}) {compress_level}")
            else:
                cv2.imwrite(osp.join(save_path, f"{idx:08d}.png"), img)
            idx += 1
            if idx % 500 == 0:
                print(f"{idx} images")
    if save_type == "lmdb":
        writer.commit()
        with open(osp.join(save_path, "meta_info.txt"), "w") as f:
            f.write("\n".join(meta) + "\n")
    print(f"done: {idx} images -> {save_path}")


def convert_celeba_tfrecords(tf_pattern, log_resolution, save_root,
                             save_type="img", compress_level=1):
    """CelebA records store HWC under 'data' with 'shape' (h,w,c)."""
    res = 2 ** log_resolution
    phase = "train"
    if save_type == "lmdb":
        from ..utils.lmdb_util import LmdbWriter
        save_path = osp.join(save_root, f"celeba_{res}_{phase}.lmdb")
        writer = LmdbWriter(save_path)
    else:
        save_path = osp.join(save_root, f"celeba_{res}_{phase}")
        os.makedirs(save_path, exist_ok=True)
    idx = 0
    meta = []
    for tf_file in sorted(glob.glob(tf_pattern)):
        for record in iter_tfrecord(tf_file):
            feats = parse_example(record)
            h, w, c = feats["shape"]
            img = np.frombuffer(feats["data"][0],
                                np.uint8).reshape(h, w, c)[:, :, ::-1]
            if save_type == "lmdb":
                ok, buf = cv2.imencode(
                    ".png", img,
                    [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
                key = f"{idx:08d}/r{log_resolution:02d}"
                writer.put(key, buf.tobytes())
                meta.append(f"{key}.png ({h},{w},{c}) {compress_level}")
            else:
                cv2.imwrite(osp.join(save_path, f"{idx:08d}.png"), img)
            idx += 1
    if save_type == "lmdb":
        writer.commit()
        with open(osp.join(save_path, "meta_info.txt"), "w") as f:
            f.write("\n".join(meta) + "\n")
    print(f"done: {idx} images -> {save_path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="ffhq", choices=("ffhq", "celeba"))
    p.add_argument("--tf_pattern", required=True,
                   help="glob of .tfrecords files")
    p.add_argument("--log_resolution", type=int, default=10)
    p.add_argument("--save_root", default="datasets/ffhq")
    p.add_argument("--save_type", default="img", choices=("img", "lmdb"))
    args = p.parse_args(argv)
    fn = (convert_ffhq_tfrecords if args.dataset == "ffhq"
          else convert_celeba_tfrecords)
    fn(args.tf_pattern, args.log_resolution, args.save_root, args.save_type)


if __name__ == "__main__":
    main()
