"""Int8 inference under tensor parallelism (``ModelConfig.quantized_inference``
with ``parallel/tensor_parallel.py``): two spawned gloo CPU ranks as one
model group (data 1 x model 2, ``parallel/dryrun.py:run_spawned``) run the
int8 dual student of a 2-block, 4-head ViT (tests/test_torch_tensor_parallel.py's
``test_quad_patch16``) through ``cam_only``, ``forward_with_cams`` and
``ops/cam.py:multi_scale_cam_with_outputs``, in fp32 and in bench compute
(bf16 compute and stream, the tanh GELU), against one process: the CAMs,
aux CAMs and class scores bit for bit (a row-parallel product all-reduces
its maxima, then its exact int32 sums, then rescales), the segmentation
logits within the bf16 path's tensor-parallel bounds (the decoder's conv6
and conv7 are not quantized: their fp32 partial sums are reordered); a
planted fault (each rank rescales its int32 sum and rank 0 adds the bias
before an fp32 sum) is not bit-equal.  In this process, the same weights
through the JAX package's ``DualStudent`` placed by ``param_sharding`` on a
``make_mesh(n_data=1, n_model=2)`` mesh: its CAMs bit-equal to the one-device
ones (GSPMD partitions the int8 product exactly), and within
tests/test_torch_quant.py's ``INT8_REL`` of the port's.

The ranks import this module; it imports the JAX package only inside the
tests and fixtures that run in this process."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.models import vit
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.ops import quant
from dupl_tpu_torch.parallel import dryrun, tensor_parallel

torch.set_num_threads(2)
BACKBONE = "test_quad_patch16"
SPEC = {"embed_dim": 64, "depth": 2, "num_heads": 4}
CROP = 64
COMPUTE = {"fp32": {},
           "bench": dict(compute_dtype="bfloat16", stream_dtype="bfloat16",
                         gelu_approximate=True)}
# the outputs held bit for bit; seg by SEG_TOL
EXACT = ("cam", "cam_aux", "cls", "fcam", "fcam_aux", "msc_cam", "msc_aux")
# seg against one process: tests/test_parallel.py:143's metric tolerance in
# fp32; in bf16 a reordered fp32 sum rounds to a neighbouring bf16 value,
# and the decoder's ReLU and conv8 carry that ulp on (the bf16 bound of
# INT8_REL, of the output's largest magnitude: max, mean)
SEG_TOL = {"fp32": dict(rtol=2e-4, atol=1e-5), "bench": (5e-2, 1e-2)}


def _model_cfg(compute):
    return {"backbone": BACKBONE, "compute_dtype": "float32",
            "quantized_inference": True, **COMPUTE[compute]}


def _faulty_row_parallel(x, w, bias, d, gelu=None):
    """The planted fault: each rank rescales its own int32 sum (rank 0
    adding the bias) and the fp32 partials are summed."""
    x2, wq, b = quant.product_operands(x, w, bias, gelu)
    amax_x, amax_w = quant.row_absmax_pair(x2, wq, gelu)
    amax = torch.cat([amax_x, amax_w])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=d.model_group)
    m = x2.shape[0]
    qa, sa, qw, sw = quant.quantize_pair_given(x2, wq, amax[:m], amax[m:],
                                               gelu)
    y = quant.int8_rescale(quant.int8_matmul_i32(qa, qw), sa, sw,
                           b if d.model_rank == 0 else None)
    dist.all_reduce(y, group=d.model_group)
    return y.reshape(*x.shape[:-1], w.shape[0])


def outputs(weights, images, d=None, fault=False, computes=tuple(COMPUTE)):
    """The int8 dual student's outputs in each of ``computes``,
    as numpy: both students' CAMs and aux CAMs (``cam_only``), the fused
    pass's seg, cls and CAMs (``forward_with_cams``) and each student's
    multi-scale CAMs, aux CAMs and seg (``multi_scale_cam_with_outputs`` at
    the recipe's scales, merged at half the crop).  ``d``: this rank's
    model group (the model sharded over it); ``fault``: the planted
    fault."""
    vit.VIT_CONFIGS.setdefault(BACKBONE, vit.ViTSpec(**SPEC))
    keep = tensor_parallel.quantized_row_parallel
    if fault:
        tensor_parallel.quantized_row_parallel = _faulty_row_parallel
    x = torch.from_numpy(images)
    out = {}
    try:
        for compute in computes:
            cfg = tconfig.voc_config(model=tconfig.ModelConfig(
                **_model_cfg(compute)))
            model = DualStudent(cfg.model)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in weights.items()})
            model.eval()
            if d is not None:
                tensor_parallel.shard_model(model, d)
            with torch.no_grad():
                cam, cam_aux = model.cam_only(x)
                o, fcam, fcam_aux = model.forward_with_cams(x)
                msc = [cam_ops.multi_scale_cam_with_outputs(
                    s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                    merge_size=(CROP // 2, CROP // 2))
                    for s in (model.branch1, model.branch2)]
            res = {"cam": cam, "cam_aux": cam_aux, "fcam": fcam,
                   "fcam_aux": fcam_aux, "seg": o.seg, "cls": o.cls,
                   "msc_cam": torch.stack([m[0] for m in msc]),
                   "msc_aux": torch.stack([m[1] for m in msc]),
                   "msc_seg": torch.stack([m[2].seg for m in msc])}
            out[compute] = {k: v.float().numpy() for k, v in res.items()}
    finally:
        tensor_parallel.quantized_row_parallel = keep
    return out


@dataclasses.dataclass
class CamJob:
    """The ranks' job (``dryrun.run_spawned``): :func:`outputs` clean, and
    in fp32 with the planted fault (in bench compute the bf16 residual
    stream rounds the fault's fp32 ulps away at this size)."""

    weights: dict
    images: np.ndarray
    n_model: int = 2

    def run(self, d):
        return {"clean": outputs(self.weights, self.images, d),
                "fault": outputs(self.weights, self.images, d, fault=True,
                                 computes=("fp32",))}


@pytest.fixture(scope="module")
def setup():
    """Seeded weights of the int8 dual student (``models/convert.py:
    init_weights``, biases drawn: flax starts them at 0, and a bias added in
    the wrong place should show) in the port's layout and as the JAX
    package's parameter tree, and a batch of 2 images; the quad ViT
    registered in both packages' backbone tables for the module."""
    from dupl_tpu.models import vit as jvit
    from dupl_tpu_torch.models.convert import init_weights, state_dict_to_jax

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit.VIT_CONFIGS, BACKBONE, vit.ViTSpec(**SPEC))
        mp.setitem(jvit.VIT_CONFIGS, BACKBONE, jvit.ViTSpec(**SPEC))
        model = DualStudent(tconfig.ModelConfig(**_model_cfg("fp32")))
        gen = torch.Generator().manual_seed(0)
        init_weights(model, gen)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".bias"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        sd = model.state_dict()
        params = {}
        for key, leaf in state_dict_to_jax(sd).items():
            *path, last = key.split("/")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[last] = leaf
        weights = {k: v.numpy() for k, v in sd.items()}
        images = np.random.RandomState(21).randn(2, CROP, CROP, 3).astype(
            np.float32)
        yield params, weights, images


@pytest.fixture(scope="module")
def runs(setup):
    """One process's outputs and the two ranks' (one spawned job).  The
    ranks run one thread each (``dryrun``'s workers), and so does the one
    process here: the CPU's image resize sums in an order that depends on
    the thread count."""
    _, weights, images = setup
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = outputs(weights, images)
    finally:
        torch.set_num_threads(threads)
    ranks = dryrun.run_spawned(2, CamJob(weights, images))
    return one, ranks


@pytest.mark.parametrize("compute", list(COMPUTE))
def test_tp_ranks_equal_one_process(runs, compute):
    """Each rank's CAMs, aux CAMs and class scores (``cam_only``, the fused
    pass, the multi-scale CAMs) equal one process's bit for bit; the
    segmentation logits, whose decoder convolutions sum fp32 partials over
    the ranks, are within :data:`SEG_TOL`; in fp32 the planted fault moves
    the CAMs and the class scores."""
    one, ranks = runs
    want = one[compute]
    for r in ranks:
        got = r["clean"][compute]
        for k in EXACT:
            assert got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), (k, np.abs(
                got[k] - want[k]).max())
        for k in ("seg", "msc_seg"):
            if compute == "fp32":
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **SEG_TOL[compute])
            else:
                err = np.abs(got[k] - want[k]) / np.abs(want[k]).max()
                assert err.max() <= SEG_TOL[compute][0], (k, err.max())
                assert err.mean() <= SEG_TOL[compute][1], (k, err.mean())
        if compute == "fp32":
            bad = r["fault"][compute]
            assert not np.array_equal(bad["cam"], want["cam"])
            assert not np.array_equal(bad["cls"], want["cls"])
    assert all(np.array_equal(ranks[0]["clean"][compute][k],
                              ranks[1]["clean"][compute][k]) for k in EXACT)


@pytest.mark.parametrize("compute", list(COMPUTE))
def test_jax_mesh_int8_cams_equal_one_device(setup, runs, compute):
    """The JAX ``DualStudent.cam_only`` (int8, jitted) with its params
    placed by ``param_sharding`` on a 1 x 2 mesh gives the one-device CAMs
    bit for bit, and both lie within ``INT8_REL`` of the port's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from dupl_tpu.config import ModelConfig as JModelConfig
    from dupl_tpu.config import voc_config as j_voc_config
    from dupl_tpu.models import vit as jvit
    from dupl_tpu.models.network import DualStudent as JDualStudent
    from dupl_tpu.parallel import make_mesh
    from dupl_tpu.parallel.mesh import param_sharding
    from test_torch_quant import INT8_REL

    params, _, images = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, BACKBONE, jvit.ViTSpec(**SPEC))
        jcfg = j_voc_config(model=JModelConfig(**_model_cfg(compute)))
        jmodel = JDualStudent(jcfg.model)
        fn = jax.jit(jmodel.cam_only)
        one = fn(params, jnp.asarray(images))
        mesh = make_mesh(n_data=1, n_model=2)
        placed = jax.device_put(params, param_sharding(mesh, params))
        x = jax.device_put(jnp.asarray(images), NamedSharding(mesh, P()))
        sharded = fn(placed, x)
    port = runs[0][compute]
    bound = INT8_REL["float32" if compute == "fp32" else "bfloat16"]
    for a, b, name in zip(one, sharded, ("cam", "cam_aux")):
        a = np.asarray(a.astype(jnp.float32))
        b = np.asarray(b.astype(jnp.float32))
        assert np.array_equal(a, b), name
        err = np.abs(port[name] - a) / np.abs(a).max()
        assert err.max() <= bound[0] and err.mean() <= bound[1], (
            name, err.max(), err.mean())
