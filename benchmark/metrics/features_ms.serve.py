"""Device ms of the feature networks per served batch: the program's
``hat.features`` span over both VGG16-UNet branches (the convolutions
with the pooling, upsampling, normalization and layout copies that
``conv_ms.serve`` leaves out), the stream time between its entry and its
exit."""

from benchmark.harness import spans


def read(t):
    return spans.ms_per_call(t, ("hat.features",), "device")
