"""Model FLOPs utilization of the whole step, in percent (``mfu.serve``,
``mfu.train``): the two VGG16-UNet branches' convolution FLOPs of one
call (x3 for a training step), counted from the shapes, over the time of
one call as an untraced window of the same calls just before the traced
one reads it (so the profiler's own cost is left out), and the card's
published peak in the precision the convolutions run in (bf16 989, TF32
495, float32 67 TFLOP/s; H100 SXM at 700 W)."""

from benchmark.harness import counts


def read(t):
    flops = counts.model_flops(t.model, t.traffic["batch"],
                               t.traffic["route"] == "train")
    peak = counts.PEAK_FLOPS[counts.precision(t.route)]
    return 100.0 * flops / t.call_s / peak
