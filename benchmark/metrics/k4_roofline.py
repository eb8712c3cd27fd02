"""``k4_roofline``: K4 (``dupl::par_propagate``, all its rounds) at its
share of its roofline, in %: the least times of its calls, each from its
recorded masks (B, C, H, W), affinity (B, K, H, W) and affinity type and
the configuration's rounds (``counts.k4_bound``), summed, over the device
time of the kernels those calls ran, in the profiler's pass."""

from benchmark import counts, trace

_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2}


def read(ctx):
    got = ctx.op_kernels("dupl::par_propagate")
    if not got:
        return None
    ops, kerns = got
    rounds = ctx.config["par"]["num_iter"]
    bound = 0.0
    for o in ops:
        (b, c, h, w), (_, taps, _, _) = trace.input_dims(o)[:2]
        aff = _BYTES[trace.input_types(o)[1]]
        bound += counts.k4_bound(b, c, h, w, taps, rounds, aff)
    busy = sum(float(k["dur"]) for k in kerns) * 1e-6
    return 100.0 * bound / busy if busy and bound else None
