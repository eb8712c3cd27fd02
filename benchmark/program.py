"""The system under test: ``dupl_tpu_torch``'s configuration and dual
student built from a configuration's file and the seeded weights.

The port's configuration is ``dupl_tpu_torch.config.bench_config`` of the
file's ``port`` settings; every number the file states is then checked
against what the port will run, so the file is the configuration as it is
run.  The model is built on the meta device and takes the benchmark's
weights as its parameters (``load_state_dict(assign=True)``), so set-up
allocates them once.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPE_NAMES = ("compute_dtype", "stream_dtype")


def port_config(config: dict, quantized: Optional[bool] = None):
    """The port's ``TrainConfig`` of a configuration's file (``quantized``
    overrides ``quantized_inference``: the bf16 cells' control)."""
    from dupl_tpu_torch.config import bench_config

    q = config["quantized_inference"] if quantized is None else quantized
    cfg = bench_config(config["port"]["dataset"],
                       backbone=config["port"]["backbone"],
                       quantized_inference=q)
    check_port_config(config, cfg, q)
    return cfg


def check_port_config(config: dict, cfg, quantized: bool) -> None:
    """Raise ``ValueError`` where the port would run other sizes or
    settings than the file states."""
    from dupl_tpu_torch.models.vit import VIT_CONFIGS

    spec = VIT_CONFIGS[cfg.model.backbone]
    m, par, crf = cfg.model, cfg.par, cfg.crf
    have = {
        "embed_dim": spec.embed_dim, "depth": spec.depth,
        "num_heads": spec.num_heads,
        "mlp_dim": int(spec.embed_dim * spec.mlp_ratio),
        "patch_size": spec.patch_size, "pretrained_grid": spec.pretrained_grid,
        "num_classes": m.num_classes, "aux_layer": m.aux_layer,
        "decoder_dim": m.decoder_dim, "decoder_dilation": m.decoder_dilation,
        "gelu": "tanh" if m.gelu_approximate else "erf",
        "compute_dtype": m.compute_dtype, "stream_dtype": m.stream_dtype,
        "quantized_inference": m.quantized_inference,
        "cam_scales": list(cfg.cam_scales), "high_thre": cfg.high_thre,
        "low_thre": cfg.low_thre, "ignore_index": cfg.ignore_index,
        "par": {"dilations": list(par.dilations), "num_iter": par.num_iter,
                "w1": par.w1, "w2": par.w2, "down_scale": par.down_scale,
                "compute_dtype": par.compute_dtype,
                "class_budget": par.class_budget},
        "crf": {"iter_max": crf.iter_max, "pos_w": crf.pos_w,
                "pos_xy_std": crf.pos_xy_std, "bi_w": crf.bi_w,
                "bi_xy_std": crf.bi_xy_std, "bi_rgb_std": crf.bi_rgb_std},
    }
    want = dict(config, quantized_inference=quantized)
    bad = []
    for key, value in have.items():
        stated = want[key]
        if isinstance(value, dict):
            bad += [f"{key}.{k}: file {stated[k]!r}, port {v!r}"
                    for k, v in value.items() if stated[k] != v]
        elif stated != value:
            bad.append(f"{key}: file {stated!r}, port {value!r}")
    if bad:
        raise ValueError("the port runs another configuration than "
                         f"{config['name']}: " + "; ".join(bad))


def build_model(cfg, weights: dict, device) -> torch.nn.Module:
    """The port's ``DualStudent`` of ``cfg`` holding ``weights`` (float32
    tensors on ``device``, keyed as its state dict) as its parameters."""
    from dupl_tpu_torch.models.network import DualStudent

    with torch.device("meta"):
        model = DualStudent(cfg.model)
    model.load_state_dict(weights, strict=True, assign=True)
    return model.to(device).eval()
