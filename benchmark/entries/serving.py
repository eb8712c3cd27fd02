"""The serving program: ``dupl_tpu_torch.engine.export.make_serving_fn(cfg,
model, scales=..., merge=...)`` on the ensemble of both students with the
fast CRF, called as ``fn(images)`` -> uint8 (B, H, W) labels.

The numbers it is judged by, each the worst over the judged images (or
products), read from the very call the window makes, by wrappers around
the program's own layer entries (``benchmark/capture.py``):

* ``seg_err``: both students' merged multi-scale segmentation logits,
  ||program - reference|| / ||reference|| of one image's tensor, the
  reference run from the images;
* ``crf_step_mismatch``: the share of pixels whose label, as the window
  returned it, differs from the reference's answer (the mean of both
  students, softmax, the fast CRF, argmax) on the program's own merged
  logits.  The CRF is judged on the program's input because it is
  multistable on the ensemble's peaked probabilities: a region flips
  under a 1% change of its input, so labels run from the reference's own
  logits separate no precision from sound runs (``PERF.md`` section 2);
* ``gemm_err`` (``capture.judge_products``): every block product's output
  rows against the reference's product of the program's own input rows;
* ``rerun_mismatch``: the share of labels that differ between the window's
  last call on a batch and the judged call on it.

``crf_mismatch``, the window's labels against the reference's labels from
the images, is recorded beside them and held to no limit.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import capture, compare, counts


class Entry:
    def __init__(self, cfg, model, config: dict, traffic: dict, device):
        from dupl_tpu_torch.engine.export import make_serving_fn

        self.cfg, self.model, self.config = cfg, model, config
        self.traffic, self.device = traffic, device
        self.scales = tuple(traffic["scales"])
        self.fn = None if model is None else make_serving_fn(
            cfg, model, scales=self.scales, merge=traffic["merge"],
            branch="ensemble", crf=True)

    def release(self) -> None:
        """Drop the program (the model and its weights)."""
        self.fn = self.model = None

    def flops(self):
        """The model FLOPs of a call, by type."""
        t = self.traffic
        return counts.serving_flops(self.config, t["batch"], t["crop"], t["crop"],
                                    self.scales)

    def inputs(self, batch: dict) -> tuple:
        return (torch.from_numpy(batch["images"]).to(self.device),)

    def __call__(self, args: tuple):
        return (self.fn(*args),)

    def capture(self, args: tuple, seed: int) -> dict:
        """One call of the entry, with the floats its layers produced and
        took."""
        from dupl_tpu_torch.engine import export

        got: dict = {"products": []}

        def keep(name, pick):
            def k(a, kw, out):
                got.setdefault(name, []).append(
                    tuple(t.float().clone() for t in pick(a, out)))
            return k

        with contextlib.ExitStack() as stack:
            stack.enter_context(capture.wrapped(
                export, "msc_seg_logits", keep("seg", lambda a, out: (out,))))
            stack.enter_context(capture.product_rows(self.model, seed,
                                                     got["products"]))
            out = self.fn(*args)
        (seg,), = got["seg"]
        return {"seg": seg, "out": (out,), "products": got["products"]}

    def staged(self, args: tuple, mark) -> None:
        """The program's forward, layer entry by layer entry, with ``mark``
        after each stage."""
        from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
        from dupl_tpu_torch.ops import crf as crf_ops
        from dupl_tpu_torch.ops import image as image_ops

        (images,) = args
        with torch.inference_mode():
            x, image01 = image_ops.prepare_inputs(images)
            mark("start")
            seg = msc_seg_logits(lambda both: self.model(both).seg, x,
                                 x.shape[1:3], self.scales,
                                 self.traffic["merge"], batch_dims=2)
            mark("seg")
            probs = torch.softmax(seg.mean(dim=0), dim=-1)
            crf_ops.crf_from_config(image01, probs, self.cfg.crf, fast=True,
                                    return_logits=True).argmax(dim=-1)
            mark("crf")

    @staticmethod
    def stage_inputs(capt: dict, js) -> dict:
        """The merged logits of images ``js`` of a capture, the CRF's
        input."""
        return {"seg": capt["seg"][:, js]}

    def reference(self, ref, weights: dict, batch: dict, js, stage: dict,
                  prec=None, record=None) -> dict:
        """The reference on images ``js`` of ``batch``, and its answer
        again on the program's own merged logits ``stage``."""
        images = torch.from_numpy(batch["images"][js]).to(self.device)
        out = ref.serving(weights, self.config, images, self.scales,
                          self.traffic["merge"], prec=prec, record=record)
        if stage is not None:
            _, image01 = ref.prepare(images)
            out["step_labels"] = ref.serving_labels(
                image01, stage["seg"].to(self.device), self.config)
        return out

    @staticmethod
    def from_reference(out: dict):
        """A reference's output in the place of the program's: (the
        captured floats, the labels a window would hold)."""
        return {"seg": out["seg"]}, (out["labels"],)

    @staticmethod
    def rerun(window_out, capt_out) -> float:
        return compare.mismatch(window_out[0], capt_out[0])

    @staticmethod
    def judge_images(capt: dict, window_out, ref: dict, js) -> list:
        return [{"seg_err": max(compare.rel_err(capt["seg"][v, j],
                                                ref["seg"][v, n])
                                for v in range(2)),
                 "crf_step_mismatch": compare.mismatch(window_out[0][j],
                                                       ref["step_labels"][n]),
                 "crf_mismatch": compare.mismatch(window_out[0][j],
                                                  ref["labels"][n])}
                for n, j in enumerate(js)]
