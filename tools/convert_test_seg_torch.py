"""Class-index PNGs -> VOC-palette PNGs for the official evaluation server,
on the PyTorch port's side (counterpart of ``tools/convert_test_seg.py``;
reference: tools/convert_test_seg.py).

    python tools/convert_test_seg_torch.py --dir seg_preds \
        --target-dir seg_preds_palette

Every ``.png`` of ``--dir`` (a grayscale class-index map, as
``tools/eval_seg_torch.py --out-dir`` writes them) is written under the
same name to ``--target-dir`` as a palettised PNG with the VOC palette;
other files are skipped.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image

from dupl_tpu_torch.utils.colormap import save_indexed_png


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True, help="directory of class-index PNGs")
    p.add_argument("--target-dir", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.target_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(args.dir) if n.endswith(".png"))
    for n in names:
        with Image.open(os.path.join(args.dir, n)) as img:
            label = np.asarray(img)
        save_indexed_png(os.path.join(args.target_dir, n), label)
    print(f"converted {len(names)} masks -> {args.target_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
