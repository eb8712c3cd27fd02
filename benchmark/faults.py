"""Faults planted in the timed path under the harness, to show that the
comparison which decides ``correct`` catches them
(``benchmark/tests/test_bench_faults.py`` on a tiny cell;
``readings.py --fault`` at a cell's own size on the card).
Each is a context manager that swaps one of the program's layer entries
(looked up at call time) and puts it back.

* ``answer_altered``: every image's answer one class off where it is
  produced, at the fast CRF's logits (both entries' answers are the CRF's
  argmax).  Every image, because at a cell's own size the check judges a
  sample of the images: a fault in one image of each batch escapes the
  sample of about one seed in eighteen;
* ``crf_skipped``: the fast CRF returns its input's log-probabilities, so
  the answer is the argmax before the CRF;
* ``half_batch``: the encoder's stage on the first half of the batch, its
  results repeated for the second half.

A step that returns its state unchanged and the exchange between chips do
not exist in these one-card inference cells.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("answer_altered", "crf_skipped", "half_batch")


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def answer_altered(entry: str):
    from dupl_tpu_torch.ops import crf

    def make(orig):
        def fn(*a, **k):
            return torch.roll(orig(*a, **k), 1, dims=-1)
        return fn

    return _patched(crf, "crf_from_config", make)


def crf_skipped(entry: str):
    from dupl_tpu_torch.ops import crf

    def make(orig):
        def fn(image01, probs, cfg, **k):
            return torch.log(probs.clamp_min(1e-30))
        return fn

    return _patched(crf, "crf_from_config", make)


def half_batch(entry: str):
    def repeat(t, b):
        return t[torch.arange(b, device=t.device) % max(1, b // 2)]

    if entry == "pseudo_label":
        from dupl_tpu_torch.ops import cam

        def make(orig):
            def fn(full_fn, cam_fn, inputs, scales, **k):
                b = inputs.shape[0]
                cams, aux, out = orig(full_fn, cam_fn,
                                      inputs[:max(1, b // 2)], scales, **k)
                return (repeat(cams, b), None if aux is None else
                        repeat(aux, b),
                        type(out)(*(repeat(a, b) for a in out)))
            return fn

        return _patched(cam, "multi_scale_cam_with_outputs", make)
    from dupl_tpu_torch.engine import export

    def make(orig):
        def fn(seg_fn, x, *a, **k):
            b = x.shape[0]
            seg = orig(seg_fn, x[:max(1, b // 2)], *a, **k)
            return seg[:, torch.arange(b, device=seg.device) % max(1, b // 2)]
        return fn

    return _patched(export, "msc_seg_logits", make)


def plant(name: str, entry: str):
    """The fault ``name`` (one of ``NAMES``) for the program entry
    ``entry``."""
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    return globals()[name](entry)
