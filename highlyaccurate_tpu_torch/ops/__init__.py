"""The port's hand-written kernels and their plain versions.

``launch_counters`` names each kernel's wrapper by its id; a wrapper's
``launches`` attribute counts the launches of its CUDA kernel (never its
plain version's runs on the CPU).  ``reset_launches``, ``launch_counts``
and ``expect_launches`` are the one place that reads and checks them.
The banded kernels' wrappers (K1-K3) also count, in ``unswapped``, those
of their launches that took the map in the unswapped layout
(``unswapped_launch_counts``).
"""

BANDED = ("k1", "k2", "k3")


def launch_counters() -> dict:
    """{"k1": ..., "k7": ...}: the wrapper of each kernel, whose
    ``launches`` counts its launches."""
    from highlyaccurate_tpu_torch.ops import banded_warp as bw
    from highlyaccurate_tpu_torch.ops import projline as tpl
    return {"k1": bw.banded_moments, "k2": bw.banded_sample,
            "k3": bw.banded_sample_backward,
            "k4": tpl.projline_sample_forward,
            "k5": tpl.projline_sample_backward, "k6": tpl.projline_pixmom,
            "k7": tpl.projline_linemom}


def reset_launches() -> None:
    """Set every kernel's launch count, and the banded kernels' unswapped
    counts, to 0."""
    for k, fn in launch_counters().items():
        fn.launches = 0
        if k in BANDED:
            fn.unswapped = 0


def launch_counts() -> dict:
    """{"k1": n, ..., "k7": n}: each kernel's launches so far."""
    return {k: fn.launches for k, fn in launch_counters().items()}


def unswapped_launch_counts() -> dict:
    """{"k1": n, "k2": n, "k3": n}: the banded kernels' launches so far in
    the unswapped layout (``banded_project(swap=False)``: kernel x is the
    map's own contiguous row axis, as under the Ford data's rig), of those
    ``launch_counts`` counts."""
    counters = launch_counters()
    return {k: counters[k].unswapped for k in BANDED}


def expect_launches(what: str, expected: dict) -> dict:
    """Every kernel's launch count since ``reset_launches``; raises
    ``RuntimeError`` unless the kernels in ``expected`` launched exactly
    that often and the others never."""
    got = launch_counts()
    want = {k: expected.get(k, 0) for k in got}
    if got != want:
        raise RuntimeError(f"{what} launched the kernels {got} times, "
                           f"expected {want}")
    return got
