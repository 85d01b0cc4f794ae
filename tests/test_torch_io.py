"""The port's IO backends (lmdb, pak, memcached) against the JAX package on
the CPU.

  * lmdb both ways: the port's writer read by JAX's `LmdbReader` and JAX's
    writer read by the port's, with one leaf page and with branch pages,
    each with values over a 4 KB page (overflow pages); `make_lmdb_from_imgs`
    writes the same bytes as JAX's;
  * pak both ways, the `create_pak` CLI, the native reader built with g++
    into `_build/` (`read`, `read_batch`, range checks), the Python reads
    taken only without a compiler;
  * memcached's text protocol against an in-process socket server, one and
    two servers;
  * the GT-only datasets on an lmdb and a pak, item by item equal to JAX's
    on the same store;
  * the StyleGAN2 config trained 2 steps through `train_pipeline` with its
    `io_backend: {type: lmdb}` as written (only the widths, the steps and
    `dataroot_gt` cut).
"""

import logging
import os
import random
import socket
import threading

import cv2
import numpy as np
import pytest
import torch

from image_restoration_tpu.data import datasets as jax_datasets
from image_restoration_tpu.utils import lmdb_util as jax_lmdb
from image_restoration_tpu.utils.file_client import FileClient as JaxClient
from image_restoration_tpu.utils.file_client import write_pak as jax_write_pak
from image_restoration_tpu_torch.data import build_dataset
from image_restoration_tpu_torch.native import pakio
from image_restoration_tpu_torch.scripts import create_pak
from image_restoration_tpu_torch.train import train_pipeline
from image_restoration_tpu_torch.utils import lmdb_util
from image_restoration_tpu_torch.utils.file_client import (FileClient,
                                                           read_pak_index,
                                                           write_pak)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), os.pardir))
SG2_CONFIG = "configs/options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ.yml"


def _items(n, seed):
    """`n` keyed random values of 20-200 bytes and two over a 4 KB page."""
    rng = np.random.default_rng(seed)
    items = {f"img_{i:05d}": rng.integers(0, 256, rng.integers(20, 200))
             .astype(np.uint8).tobytes() for i in range(n)}
    items["big_a"] = rng.integers(0, 256, 5000).astype(np.uint8).tobytes()
    items["big_b"] = rng.integers(0, 256, 30000).astype(np.uint8).tobytes()
    return items


class _Records(logging.Handler):
    """The file client's log records while the `with` block runs (its own
    handler: the package's logger may not propagate to pytest's)."""

    def __enter__(self):
        self.logger = logging.getLogger(
            "image_restoration_tpu_torch.utils.file_client")
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        self.text = ""
        return self

    def emit(self, record):
        self.text += record.getMessage() + "\n"

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def _write(writer_cls, path, items):
    w = writer_cls(str(path))
    for k, v in items.items():
        w.put(k, v)
    w.commit()


# ------------------------------------------------------------------- lmdb


@pytest.mark.parametrize("n_keys", [10, 300], ids=["leaf", "branches"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_lmdb_round_trip_with_jax(tmp_path, direction, n_keys):
    """Every value back through the other package's reader, keys in order,
    the entry count, and a missing key; 300 keys need branch pages."""
    items = _items(n_keys, n_keys)
    writer, reader = ((lmdb_util.LmdbWriter, jax_lmdb.LmdbReader)
                      if direction == "port_to_jax" else
                      (jax_lmdb.LmdbWriter, lmdb_util.LmdbReader))
    _write(writer, tmp_path / "x.lmdb", items)
    r = reader(str(tmp_path / "x.lmdb"))
    try:
        assert r.entries == len(items)
        for k, v in items.items():
            assert r.get(k) == v, k
        assert r.get("missing") is None
        assert [k.decode() for k in r.keys()] == sorted(items)
        depth = r._db[0][2]
        assert depth == (1 if n_keys == 10 else 2)
    finally:
        r.close()


def test_make_lmdb_from_imgs_matches_jax(tmp_path):
    """The same folder gives the same data.mdb and meta_info.txt bytes."""
    os.makedirs(tmp_path / "src")
    rng = np.random.default_rng(1)
    names = []
    for i in range(5):
        names.append(f"face_{i}.png")
        cv2.imwrite(str(tmp_path / "src" / names[-1]),
                    rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    keys = [n[:-4] for n in names]
    for mod, out in ((lmdb_util, "port.lmdb"), (jax_lmdb, "jax.lmdb")):
        assert mod.make_lmdb_from_imgs(str(tmp_path / "src"),
                                       str(tmp_path / out), names, keys) == 5
    for f in ("data.mdb", "meta_info.txt"):
        assert (tmp_path / "port.lmdb" / f).read_bytes() == \
            (tmp_path / "jax.lmdb" / f).read_bytes()
    client = FileClient("lmdb", db_paths=str(tmp_path / "port.lmdb"))
    assert sorted(client.keys()) == keys
    img = cv2.imdecode(np.frombuffer(client.get("face_3"), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(img, cv2.imread(
        str(tmp_path / "src" / "face_3.png"), cv2.IMREAD_UNCHANGED))


# -------------------------------------------------------------------- pak


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pak_round_trip_with_jax(tmp_path, direction):
    items = _items(20, 2)
    path = str(tmp_path / "data.pak")
    (write_pak if direction == "port_to_jax" else jax_write_pak)(
        items.items(), path)
    client = (JaxClient if direction == "port_to_jax" else FileClient)(
        "pak", pak_path=path)
    for k, v in items.items():
        assert client.get(k) == v
    assert set(read_pak_index(path)) == set(items)


def test_create_pak_cli(tmp_path):
    """The CLI packs a folder (keys: sorted relative paths) that JAX's
    client reads back file by file."""
    os.makedirs(tmp_path / "src" / "sub")
    rng = np.random.default_rng(3)
    rels = ["a.png", "b.jpg", "sub/c.png"]
    for rel in rels:
        cv2.imwrite(str(tmp_path / "src" / rel),
                    rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    (tmp_path / "src" / "notes.txt").write_text("x")
    out = str(tmp_path / "x.pak")
    assert create_pak.main(["--input", str(tmp_path / "src"), "--output",
                            out]) == 3
    jc = JaxClient("pak", pak_path=out)
    assert sorted(jc._client.keys()) == rels
    for rel in rels:
        assert jc.get(rel) == (tmp_path / "src" / rel).read_bytes()


def test_native_pak_reader(tmp_path):
    """The pak backend takes the native reader, built with g++ into
    `_build/libpakio_<hash>.so`: single and batched reads equal the
    records, and a record outside the blob is refused."""
    items = _items(20, 4)
    path = str(tmp_path / "data.pak")
    write_pak(items.items(), path)
    with _Records() as log:
        client = FileClient("pak", pak_path=path)
    assert client._client.reader == "native"
    assert "native reader" in log.text
    lib = pakio.library_path()
    assert lib.parent == pakio.BUILD_DIR and lib.name.startswith("libpakio_")
    for k, v in items.items():
        assert client.get(k) == v
    index = read_pak_index(path)
    reader = pakio.NativePakReader(path, workers=3)
    keys = sorted(items)[::2]
    got = reader.read_batch([index[k][0] for k in keys],
                            [index[k][1] for k in keys])
    assert got == [items[k] for k in keys]
    assert reader.read_batch([], []) == []
    with pytest.raises(ValueError, match="outside"):
        reader.read(reader.size - 2, 4)
    reader.close()
    client.close()


def test_pak_python_reads_only_without_a_compiler(tmp_path, monkeypatch):
    """Without a C++ compiler the backend reads with Python (and says so);
    any other failure of the native reader raises."""
    items = _items(5, 5)
    path = str(tmp_path / "data.pak")
    write_pak(items.items(), path)

    def no_compiler():
        raise pakio.CompilerNotFound("no C++ compiler (g++) on PATH")

    monkeypatch.setattr(pakio, "_load", no_compiler)
    with _Records() as log:
        client = FileClient("pak", pak_path=path)
    assert client._client.reader == "python"
    assert "reading with Python" in log.text
    assert all(client.get(k) == v for k, v in items.items())
    client.close()

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(pakio, "_load", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        FileClient("pak", pak_path=path)


# -------------------------------------------------------------- memcached


class _FakeMemcached:
    """In-process memcached server speaking the text protocol's `get`."""

    def __init__(self, store):
        self.store = store
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            with conn, conn.makefile("rb") as rfile:
                for line in iter(rfile.readline, b""):
                    parts = line.split()
                    out = b""
                    for key in parts[1:]:
                        data = self.store.get(key.decode())
                        if data is not None:
                            out += b"VALUE %s 0 %d\r\n%s\r\n" % (
                                key, len(data), data)
                    conn.sendall(out + b"END\r\n")

    def close(self):
        self.srv.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept
        self.srv.close()
        self.thread.join(timeout=10)


@pytest.mark.parametrize("n_servers", [1, 2])
def test_memcached_text_protocol(tmp_path, n_servers):
    """Binary values (with \\r\\n and END inside, and empty) come back
    through one connection per server, keys sharded by md5 over two; a
    miss raises KeyError."""
    rng = np.random.default_rng(6)
    store = {f"img_{i:03d}.png": rng.integers(0, 256, 4096).astype(
        np.uint8).tobytes() for i in range(6)}
    store["crlf"] = b"head\r\nEND\r\ntail" * 7
    store["empty"] = b""
    servers = [_FakeMemcached(store) for _ in range(n_servers)]
    try:
        cfg = tmp_path / "server_list.conf"
        cfg.write_text("".join(f"127.0.0.1:{s.port}\n" for s in servers))
        client = FileClient("memcached", server_list_cfg=str(cfg),
                            client_cfg=str(tmp_path / "client.conf"))
        for _ in range(2):
            for key, data in store.items():
                assert client.get(key) == data
        with pytest.raises(KeyError):
            client.get("missing_key")
        if n_servers == 2:
            shards = {client._client._shard(k) for k in store}
            assert shards == {0, 1}
        client.close()
    finally:
        for s in servers:
            s.close()
    assert not any(s.thread.is_alive() for s in servers)


def test_unknown_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported file backend"):
        FileClient("s3")
    with pytest.raises(ValueError, match="unsupported file backend"):
        build_dataset(dict(type="FFHQDataset", dataroot_gt=str(tmp_path),
                           io_backend={"type": "s3"}))


# --------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A folder of 4 seeded 48×40 PNGs and the lmdb and pak made from it."""
    root = tmp_path_factory.mktemp("stores")
    os.makedirs(root / "src")
    rng = np.random.default_rng(7)
    names = []
    for i in range(4):
        names.append(f"{i:05d}.png")
        cv2.imwrite(str(root / "src" / names[-1]),
                    rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    lmdb_util.make_lmdb_from_imgs(str(root / "src"), str(root / "x.lmdb"),
                                  names, [n[:-4] for n in names])
    create_pak.main(["--input", str(root / "src"), "--output",
                     str(root / "x.pak")])
    return {"lmdb": str(root / "x.lmdb"), "pak": str(root / "x.pak"),
            "disk": str(root / "src")}


_DATASETS = {
    "FFHQDataset": dict(use_hflip=True, mean=[0.5] * 3, std=[0.5] * 3),
    "FFHQDegradationDataset": dict(input_width=32, input_height=24),
    "RealESRGANDataset": dict(gt_size=32, use_hflip=True, use_rot=True),
    "SingleImageDataset": dict(mean=[0.5] * 3, std=[0.5] * 3),
}


@pytest.mark.parametrize("backend", ["lmdb", "pak"])
@pytest.mark.parametrize("kind", sorted(_DATASETS))
def test_datasets_on_stores_match_jax(stores, kind, backend):
    """Each GT-only (or LQ-only) dataset on an lmdb and a pak: the keys as
    paths and every item equal to JAX's dataset on the same store, under
    the same seeds for the crops and flips; and to the disk backend's."""
    root_key = "dataroot_lq" if kind == "SingleImageDataset" else \
        "dataroot_gt"
    opt = dict(_DATASETS[kind], io_backend={"type": backend},
               **{root_key: stores[backend]})
    port = build_dataset(dict(opt, type=kind))
    ref = getattr(jax_datasets, kind)(dict(opt))
    disk = build_dataset(dict(opt, type=kind, io_backend={"type": "disk"},
                              **{root_key: stores["disk"]}))
    assert port.paths == ref.paths and len(port) == 4
    out_key = "lq" if kind == "SingleImageDataset" else "gt"
    for i in range(4):
        got = []
        for ds in (port, ref, disk):
            random.seed(i)
            np.random.seed(i)
            got.append(ds[i])
        np.testing.assert_array_equal(got[0][out_key], got[1][out_key])
        np.testing.assert_array_equal(got[0][out_key], got[2][out_key])


def test_loader_reader_ends_when_the_consumer_leaves(stores):
    """A consumer that stops early (the FID statistics read the first
    num_sample images) leaves no reader thread blocked on a full queue."""
    import time
    from image_restoration_tpu_torch.data import DataLoader
    ds = build_dataset(dict(type="FFHQDataset", dataroot_gt=stores["lmdb"],
                            io_backend={"type": "lmdb"}, use_hflip=False))
    before = threading.active_count()
    loader = DataLoader(ds, batch_size=1, shuffle=False, drop_last=False,
                        prefetch=1)
    for _ in loader:
        break
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(list(loader)) == 4


# --------------------------------------------------- the StyleGAN2 config


def test_stylegan2_config_trains_on_its_lmdb(tmp_path):
    """`train_StyleGAN2_256_Cmul2_FFHQ.yml` with `io_backend: {type: lmdb}`
    as written: `dataroot_gt` points at an lmdb of 4 seeded 32² images, the
    widths are cut to a 32² G and D, 2 iterations with R1 and the path
    step at 2; every loss finite and the checkpoint written."""
    os.makedirs(tmp_path / "src")
    rng = np.random.default_rng(8)
    names = [f"{i:05d}.png" for i in range(4)]
    for n in names:
        cv2.imwrite(str(tmp_path / "src" / n),
                    (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    db = tmp_path / "ffhq_32.lmdb"
    lmdb_util.make_lmdb_from_imgs(str(tmp_path / "src"), str(db), names,
                                  [n[:-4] for n in names])
    tiny = ["network_g:out_size=32", "network_g:num_style_feat=16",
            "network_g:num_mlp=2", "network_g:channel_multiplier=0.25",
            "network_g:narrow=0.125", "network_d:out_size=32",
            "network_d:channel_multiplier=0.25", "network_d:narrow=0.125"]
    argv = ["-opt", os.path.join(REPO, SG2_CONFIG), "--force_yml",
            f"datasets:train:dataroot_gt={db}",
            "train:net_d_reg_every=2", "train:net_g_reg_every=2",
            "train:total_iter=2", "logger:print_freq=1",
            "logger:save_checkpoint_freq=2", "logger:use_tb_logger=false",
            *tiny]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = train_pipeline(str(tmp_path), argv=argv, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert model.opt["datasets"]["train"]["io_backend"] == {"type": "lmdb"}
    assert model.iter == 2
    assert {"l_d_r1", "l_g_path"} <= set(model.log_dict)
    assert all(np.isfinite(v) for v in model.log_dict.values())
    assert os.path.exists(os.path.join(model.opt["path"]["models"],
                                       "net_g_2.pth"))
