"""CAM inference and visualisation on the PyTorch port (dupl_tpu_torch).

    python tools/infer_cam_torch.py --weights w.npz --data-folder VOC2012 \
        --list-folder datasets/voc --out-dir cam_out

Same flags as ``tools/infer_cam.py`` (reference: tools/infer_cam_voc.py),
plus ``--device`` (default ``cuda``; without a CUDA device the script
refuses to start unless ``--device cpu`` is given).  Writes jet-colormap CAM
overlays and reports CAM-label mIoU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from dupl_tpu_torch.utils.colormap import jet


def jet_overlay(image: np.ndarray, cam_max: np.ndarray) -> np.ndarray:
    """0.5*jet(cam)+0.5*image, like utils/imutils.py:255-267."""
    heat = (jet(np.clip(cam_max, 0, 1)) * 255).astype(np.float32)
    return (0.5 * heat + 0.5 * image.astype(np.float32)).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-folder", required=True)
    p.add_argument("--list-folder", default=None)
    p.add_argument("--weights", required=True)
    p.add_argument("--infer-set", default="val")
    p.add_argument("--out-dir", default="cam_out")
    p.add_argument("--branch", type=int, default=1, choices=[1, 2])
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--backbone", default=None,
                   help="override backbone (e.g. test_tiny_patch16 for smoke)")
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch paths")
    args = p.parse_args(argv)

    import dataclasses as dc

    import torch
    from PIL import Image

    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.data.voc import VocSegDataset
    from dupl_tpu_torch.engine.validate import cam_label_host
    from dupl_tpu_torch.ops import cam as cam_ops
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.utils.metrics import (add_hist, resize_logits_host,
                                              scores_from_hist)
    from dupl_tpu_torch.models.convert import load_model
    from dupl_tpu_torch.utils.device import cli_device

    device = cli_device(args.device)
    cfg = voc_config()
    if args.backbone:
        cfg = dc.replace(cfg, model=dc.replace(cfg.model, backbone=args.backbone))
    if args.crop_size:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data, crop_size=args.crop_size))
    list_folder = args.list_folder or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "datasets", "voc")
    ds = VocSegDataset(args.data_folder, list_folder, args.infer_set,
                       num_classes=cfg.num_classes)
    student = load_model(cfg, args.weights, device).student(args.branch - 1)

    os.makedirs(args.out_dir, exist_ok=True)
    hist = np.zeros((cfg.num_classes, cfg.num_classes), np.float64)
    n = len(ds) if args.max_images is None else min(args.max_images, len(ds))
    base = cfg.data.crop_size
    for i in range(n):
        s = ds[i]
        with torch.inference_mode():
            img = image_ops.resize_bilinear(image_ops.prepare_inputs(
                torch.tensor(s["image"], device=device)[None])[0], (base, base))
            cams, _ = cam_ops.multi_scale_cam(student.cam_only, img,
                                              cfg.cam_scales)
        cams = cams[0].float().cpu().numpy()
        size = s["label"].shape
        cam_up = resize_logits_host(cams, size) * s["cls_label"][None, None, :]
        label = cam_label_host(cam_up, s["cls_label"], cfg.bkg_thre)
        add_hist(hist, s["label"], label)
        overlay = jet_overlay(s["raw_image"], cam_up.max(-1))
        Image.fromarray(overlay).save(os.path.join(args.out_dir, s["name"] + ".jpg"))

    sc = scores_from_hist(hist)
    print(f"CAM-label mIoU: {100 * sc['miou']:.3f}")
    return sc


if __name__ == "__main__":
    main()
