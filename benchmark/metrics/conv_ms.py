"""Device ms of the feature networks' convolution kernels per served batch
(``conv_ms.serve``) or training step (``conv_ms.train``): every kernel
launched under ``aten::convolution`` or ``aten::convolution_backward`` in
the traced calls."""


def read(t):
    return t.conv_us / t.calls / 1e3 if t.conv_us > 0 else None
