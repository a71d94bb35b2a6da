"""Offline image pre-resize for BLIP (square BICUBIC, save as png; the
port's own copy of clipcap_tpu/tools/resize_images.py, host only, with PIL
imported inside the function so the module imports without it).

Rebuild of the reference's twin CLIs resize_images.py:22-53 /
transform_images_for_blip.py:22-55 (they differ only in defaults).
"""

from __future__ import annotations

import argparse
from pathlib import Path

EXTENSIONS = ("png", "jpg", "jpeg", "bmp")


def resize_images(
    input_folder: str,
    output_folder: str,
    image_size: int = 384,
    skip_existing: bool = True,
) -> int:
    from PIL import Image

    src = Path(input_folder)
    dst = Path(output_folder)
    dst.mkdir(parents=True, exist_ok=True)
    count = 0
    files = []
    for ext in EXTENSIONS:
        files.extend(src.glob(f"**/*.{ext}"))
    for f in sorted(files):
        out = dst / (f.stem + ".png")
        if skip_existing and out.exists():
            continue
        try:
            img = Image.open(f).convert("RGB")
        except Exception as err:
            print(f"Failed to load {f}: {err}. Skipping.")
            continue
        img = img.resize((image_size, image_size), Image.Resampling.BICUBIC)
        img.save(out)
        count += 1
    print(f"resized {count} images -> {dst}")
    return count


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--no_skip_existing", action="store_true")
    args = p.parse_args(argv)
    resize_images(args.input_folder, args.output_folder, args.image_size,
                  skip_existing=not args.no_skip_existing)


if __name__ == "__main__":
    main()
