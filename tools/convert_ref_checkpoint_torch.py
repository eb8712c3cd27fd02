"""Convert a reference-trained DuPL checkpoint (.pth) to evaluation weights
(.npz) with the PyTorch port (counterpart of
``tools/convert_ref_checkpoint.py``).

The reference publishes ``dupl_voc.pth`` / ``dupl_coco.pth``, saved as
``torch.save(model.state_dict())`` of the DDP-wrapped siamese network.  This
tool loads one through ``dupl_tpu_torch.models.pretrained.
load_reference_checkpoint`` (``module.`` stripped, both branches mapped onto
``DualStudent``) and writes the weights ``.npz`` in the JAX package's key
layout through ``engine/checkpoint.py:export_weights``; both
``tools/eval_seg_torch.py --weights`` and ``tools/eval_seg.py --weights``
read it:

    python tools/convert_ref_checkpoint_torch.py --input dupl_voc.pth \
        --output w.npz
    python tools/eval_seg_torch.py --weights w.npz --data-folder VOC2012 \
        --list-folder datasets/voc
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(input_path: str, output_path: str, verbose: bool = True) -> dict:
    """Load ``input_path``, write ``output_path``; returns the
    ``DualStudent`` state dict."""
    from dupl_tpu_torch.engine.checkpoint import export_weights
    from dupl_tpu_torch.models.pretrained import load_reference_checkpoint

    sd = load_reference_checkpoint(input_path)
    export_weights(output_path, sd)
    if verbose:
        depth = len({k.split(".")[3] for k in sd
                     if k.startswith("branch1.encoder.blocks.")})
        n_params = sum(v.numel() for v in sd.values()) // 2   # per branch
        cls = sd["branch1.classifier.weight"].shape[0] + 1
        print(f"converted {input_path} -> {output_path}: "
              f"2 branches x {n_params / 1e6:.1f}M params, "
              f"depth {depth}, {cls} classes")
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True,
                   help="reference siamese .pth (torch state_dict, "
                        "module.-prefixed or plain)")
    p.add_argument("--output", required=True, help="weights .npz to write")
    args = p.parse_args(argv)
    convert(args.input, args.output)


if __name__ == "__main__":
    main()
