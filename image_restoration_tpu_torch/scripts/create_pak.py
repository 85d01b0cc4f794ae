"""Pack an image folder into a `.pak` record store (+ `.pak.idx`).

Port of `scripts/data_preparation/create_pak.py`: the keys are the sorted
relative paths of the images, the values the files' bytes.

    python -m image_restoration_tpu_torch.scripts.create_pak \\
        --input DIR --output x.pak [--suffix png jpg]
"""

from __future__ import annotations

import argparse

from ..utils.file_client import make_pak_from_folder


def main(argv=None) -> int:
    """Run the CLI; returns the number of files packed."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--suffix", nargs="+",
                   default=["png", "jpg", "jpeg", "bmp"])
    args = p.parse_args(argv)
    n = make_pak_from_folder(args.input, args.output, tuple(args.suffix))
    print(f"packed {n} files into {args.output} (+.idx)")
    return n


if __name__ == "__main__":
    main()
