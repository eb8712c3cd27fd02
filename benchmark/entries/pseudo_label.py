"""The pseudo-label factory: ``dupl_tpu_torch.engine.export.
make_pseudo_label_fn(cfg, model)``, called as ``fn(images, cls_label,
img_box)`` -> (PAR's pseudo-labels of both students (2, B, H, W), the fast
CRF's labels (B, H, W)), uint8.

The numbers it is judged by, each the worst over the judged images (or
products), read from the very call the window makes, by wrappers around
the program's own layer entries (``benchmark/capture.py``):

* ``cam_err``, ``par_err``, ``crf_err``: ||program - reference|| /
  ||reference|| of one image's fused CAMs (both students), PAR's refined
  planes and the CRF's logits, the reference run from the images;
* ``crf_step_err``: the same for the CRF, the reference run on the
  program's own input to the CRF;
* ``refined_mismatch``, ``crf_mismatch``: the share of pixels whose label,
  as the window returned it, differs from the reference's;
* ``gemm_err`` (``capture.judge_products``): every block product's output
  rows against the reference's product of the program's own input rows;
* ``rerun_mismatch``: the share of labels that differ between the window's
  last call on a batch and the judged call on it.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import capture, compare, counts


class Entry:
    def __init__(self, cfg, model, config: dict, traffic: dict, device):
        from dupl_tpu_torch.engine.export import make_pseudo_label_fn

        self.cfg, self.model, self.config = cfg, model, config
        self.traffic, self.device = traffic, device
        self.fn = None if model is None else make_pseudo_label_fn(cfg, model)

    def release(self) -> None:
        """Drop the program (the model and its weights)."""
        self.fn = self.model = None

    def flops(self):
        """The model FLOPs of a call, by type."""
        t = self.traffic
        return counts.pseudo_label_flops(self.config, t["batch"], t["crop"],
                                         t["crop"])

    def inputs(self, batch: dict) -> tuple:
        return tuple(torch.from_numpy(batch[k]).to(self.device)
                     for k in ("images", "cls_label", "img_box"))

    def __call__(self, args: tuple):
        return self.fn(*args)

    def capture(self, args: tuple, seed: int) -> dict:
        """One call of the entry, with the floats its layers produced and
        took."""
        from dupl_tpu_torch.engine import train
        from dupl_tpu_torch.ops import cam as cam_ops
        from dupl_tpu_torch.ops import crf as crf_ops

        got: dict = {"products": []}

        def keep(name, pick):
            def k(a, kw, out):
                got.setdefault(name, []).append(
                    tuple(t.float().clone() for t in pick(a, out)))
            return k

        with contextlib.ExitStack() as stack:
            stack.enter_context(capture.wrapped(
                cam_ops, "multi_scale_cam_with_outputs",
                keep("cams", lambda a, out: (out[0],))))
            stack.enter_context(capture.wrapped(
                train, "par_fn", keep("par", lambda a, out: (out,))))
            stack.enter_context(capture.wrapped(
                crf_ops, "crf_from_config",
                keep("crf", lambda a, out: (a[0], a[1], out))))
            stack.enter_context(capture.product_rows(self.model, seed,
                                                     got["products"]))
            out = self.fn(*args)
        (par_out,), = got["par"]
        (image01, probs, logits), = got["crf"]
        return {"cams": torch.stack([c for (c,) in got["cams"]]),
                "par": par_out, "crf": logits, "crf_in": (image01, probs),
                "out": out, "products": got["products"]}

    def staged(self, args: tuple, mark) -> None:
        """The program's forward, layer entry by layer entry, with ``mark``
        after each stage."""
        from dupl_tpu_torch.engine.train import refine
        from dupl_tpu_torch.ops import cam as cam_ops
        from dupl_tpu_torch.ops import crf as crf_ops
        from dupl_tpu_torch.ops import image as image_ops

        cfg = self.cfg
        images, cls_label, img_box = args
        with torch.inference_mode():
            fits = cam_ops.fits_class_budget(cls_label, cfg.par.class_budget)
            x, image01 = image_ops.prepare_inputs(images)
            merge = (x.shape[1] // 2, x.shape[2] // 2)
            mark("start")
            cams, segs = [], []
            for i in range(2):
                s = self.model.student(i)
                cam, _, out = cam_ops.multi_scale_cam_with_outputs(
                    s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                    with_aux=False, merge_size=merge)
                cams.append(cam)
                segs.append(out.seg)
            mark("cam")
            refine(cfg, torch.stack(cams), image01, cls_label, img_box,
                   high_thre=cfg.high_thre, fits_budget=fits)
            mark("par")
            seg = image_ops.resize_bilinear(segs[0], x.shape[1:3])
            crf_ops.crf_from_config(image01, torch.softmax(seg, dim=-1),
                                    cfg.crf, fast=True,
                                    return_logits=True).argmax(dim=-1)
            mark("crf")

    @staticmethod
    def stage_inputs(capt: dict, js) -> dict:
        """The CRF's inputs of images ``js`` of a capture."""
        return {"crf_in": tuple(t[js] for t in capt["crf_in"])}

    def reference(self, ref, weights: dict, batch: dict, js, stage: dict,
                  prec=None, record=None) -> dict:
        """The reference on images ``js`` of ``batch``, and the CRF again on
        the program's own CRF input ``stage``."""
        budget = self.config["par"]["class_budget"]
        fits = budget is not None and bool(
            ((batch["cls_label"] > 0).sum(-1) < budget).all())
        dev = self.device
        out = ref.pseudo_label(
            weights, self.config,
            torch.from_numpy(batch["images"][js]).to(dev),
            torch.from_numpy(batch["cls_label"][js]).to(dev),
            torch.from_numpy(batch["img_box"][js]).to(dev), fits, prec=prec,
            record=record)
        if stage is not None:
            out["crf_step"] = ref.crf_fast_logits(
                *(t.to(dev) for t in stage["crf_in"]), self.config["crf"],
                "fp8" if prec == "fp8" else "fp32")
        return out

    @staticmethod
    def from_reference(out: dict):
        """A reference's output in the place of the program's: (the
        captured floats, the labels a window would hold)."""
        return ({"cams": out["cams"], "par": out["par"], "crf": out["crf"],
                 "crf_in": (out["image01"], out["crf_probs"])},
                (out["refined"], out["crf_labels"]))

    @staticmethod
    def rerun(window_out, capt_out) -> float:
        return max(compare.mismatch(a, b) for a, b in zip(window_out,
                                                          capt_out))

    @staticmethod
    def judge_images(capt: dict, window_out, ref: dict, js) -> list:
        rows = []
        for n, j in enumerate(js):
            crf_labels = window_out[1][j]
            rows.append({
                "cam_err": max(compare.rel_err(capt["cams"][v, j],
                                               ref["cams"][v, n])
                               for v in range(2)),
                "par_err": compare.rel_err(capt["par"][j], ref["par"][n]),
                "crf_err": compare.rel_err(capt["crf"][j], ref["crf"][n]),
                "crf_step_err": compare.rel_err(capt["crf"][j],
                                                ref["crf_step"][n]),
                "crf_mismatch": compare.mismatch(crf_labels,
                                                 ref["crf_labels"][n]),
                "refined_mismatch": max(
                    compare.mismatch(window_out[0][v, j], ref["refined"][v, n])
                    for v in range(2)),
            })
        return rows
