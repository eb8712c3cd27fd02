"""``k5_roofline``: K5 (``dupl::crf_apply``, the CRF's full-resolution
slice) at its share of its roofline, in %: the least times of its
launches, each from its recorded basis (B, N, 11) and values (B, Ns, V)
(``counts.k5_bound``), summed, over the device time of the kernels those
launches ran, in the profiler's pass."""

from benchmark import counts, trace


def read(ctx):
    got = ctx.op_kernels("dupl::crf_apply")
    if not got:
        return None
    ops, kerns = got
    bound = 0.0
    for o in ops:
        dims = trace.input_dims(o)
        (b, n, _), (_, ns, v) = dims[0], dims[3]
        bound += counts.k5_bound(b, n, ns, v)
    busy = sum(float(k["dur"]) for k in kerns) * 1e-6
    return 100.0 * bound / busy if busy and bound else None
