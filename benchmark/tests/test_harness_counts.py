"""The yardstick's counts against hand counts at a small shape, and the
trace reduction on a hand-made profile."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark.harness import counts, spec, trace
from benchmark.reference import g2sp, s2gp

MODEL = dict(sat_size=64, grd_h=32, grd_w=128, N_iters=2)


def conv(cin, cout, h, w):
    return 2 * cin * cout * 9 * h * w


def test_model_flops_by_hand():
    def branch(H, W):
        h = lambda f: (H // f) * (W // f)          # noqa: E731
        return (conv(3, 64, 1, h(1)) + conv(64, 64, 1, h(1))
                + conv(64, 128, 1, h(2)) + conv(128, 128, 1, h(2))
                + conv(128, 256, 1, h(4)) + 2 * conv(256, 256, 1, h(4))
                + conv(384, 128, 1, h(4)) + conv(128, 128, 1, h(4))
                + conv(192, 64, 1, h(2)) + conv(64, 64, 1, h(2))
                + conv(256, 1, 1, h(8)) + conv(128, 1, 1, h(4))
                + conv(64, 1, 1, h(2)))
    hand = 2 * (branch(64, 64) + branch(32, 128))
    assert counts.model_flops(MODEL, 2, train=False) == hand
    assert counts.model_flops(MODEL, 2, train=True) == 3 * hand


MODEL_FULL = dict(MODEL, grd_h=64, grd_w=256, sat_size=128,
                  shift_range_lat=20.0, shift_range_lon=20.0,
                  rotation_range=10.0, g2sp_restrict_grid=1)


def test_k1_k3_k4_bytes_by_hand():
    B = 2
    lv = [(16, 256, 8, 32), (32, 128, 16, 64), (64, 64, 32, 128)]
    assert counts.levels(MODEL_FULL) == lv
    cells = s2gp.map_cells(MODEL_FULL)
    k1 = sum(B * (n * C * 2 + (h // 2) * w * C * 4 + (h // 2) * 32
                  + (h // 2) * 192) + (h // 2) * w * 4
             for (A, C, h, w), n in zip(lv, cells)) * 2
    k3 = sum(B * (3 * (h // 2) * w * C * 4 + (h // 2) * 32 + A * A * C * 4)
             for A, C, h, w in lv) * 2
    g = g2sp.map_cells(MODEL_FULL)
    k4 = sum(B * (n * C * 2 + V * 64 + 3 * V * A * C * 4)
             for (A, C, h, w), (n, V) in zip(lv, g)) * 2
    assert counts.k1_bytes(MODEL_FULL, B, s2gp) == k1
    assert counts.k3_bytes(MODEL_FULL, B) == k3
    assert counts.k4_bytes(MODEL_FULL, B, g2sp) == k4
    assert all(0 < n <= A * A for (A, _, _, _), n in zip(lv, cells))
    assert all(0 < n <= h * w and 0 < V <= A
               for (A, _, h, w), (n, V) in zip(lv, g))


def test_k7_bytes_by_hand():
    """Per round and level, the kept samples' four float32 rows of C in
    and 9 float32 sums a line out; at most the samples that land in the
    ground map at the zero pose, counted from the pinhole by hand."""
    B = 2
    lv = counts.levels(MODEL_FULL)
    g, kept = g2sp.map_cells(MODEL_FULL), g2sp.kept_samples(MODEL_FULL)
    k7 = sum(B * (k * 4 * C * 4 + V * 9 * 4)
             for (A, C, h, w), (n, V), k in zip(lv, g, kept)) * 2
    assert counts.k7_bytes(MODEL_FULL, B, g2sp) == k7
    ranges, K = (10.0, 20.0, 20.0), g2sp.DEFAULT_K
    for (A, C, h, w), (n, V), k in zip(lv, g, kept):
        j0 = g2sp.first_column(A, h, w, ranges)
        assert V == A - j0
        fx, cx = K[0, 0] * w / 1024, K[0, 2] * w / 1024
        fy, cy = K[1, 1] * h / 256, K[1, 2] * h / 256
        mpp = s2gp.meter_per_pixel(A)
        hits = 0
        for i in range(A):                    # satellite row: X south
            for j in range(j0, A):            # served column: Z east
                X, Z = mpp * (i - A // 2), mpp * (j - A // 2)
                if Z <= 1e-6:
                    continue
                u, v = fx * X / Z + cx, fy * s2gp.CAMERA_HEIGHT / Z + cy
                hits += 0 <= u < w - 1 and 0 <= v < h - 1
        assert 0 < k <= hits


def test_k1_footprint_within_the_samples_cells():
    """At the zero pose a ground point (X, Z) falls on satellite pixel
    (u, v) = (Z, X) / mpp + A / 2: the footprint counted is at most the
    cells under every in-map sample of the kept rows."""
    cells = s2gp.map_cells(MODEL_FULL)
    for (A, C, h, w), n in zip(counts.levels(MODEL_FULL), cells):
        xyz, _ = s2gp.rays(h, w, 64, 256)
        mpp = s2gp.meter_per_pixel(A)
        hit = set()
        for X, _, Z in xyz[h // 2:].reshape(-1, 3):
            u, v = Z / mpp + A / 2, X / mpp + A / 2
            if 0 <= u < A - 1 and 0 <= v < A - 1:
                r, c = int(v), int(u)
                hit |= {(r, c), (r, c + 1), (r + 1, c), (r + 1, c + 1)}
        assert 0 < n <= len(hit)


def test_precision_of_a_route():
    assert counts.precision({"compute_dtype": "bfloat16",
                             "cudnn_allow_tf32": False}) == "bfloat16"
    assert counts.precision({"compute_dtype": "float32",
                             "cudnn_allow_tf32": False}) == "float32"
    assert counts.precision({"compute_dtype": "float32",
                             "cudnn_allow_tf32": True}) == "tf32"


def ev(name, start, end, device=DeviceType.CPU, thread=1, parent=None,
       kernels=()):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, thread=thread, cpu_parent=parent,
        kernels=list(kernels), is_async=False, is_user_annotation=False)


def test_trace_reduce_by_hand():
    cuda = DeviceType.CUDA
    K = types.SimpleNamespace
    window = ev(trace.WINDOW, 100, 200)
    conv_op = ev("aten::convolution", 105, 120)
    cudnn = ev("aten::cudnn_convolution", 106, 119, parent=conv_op,
               kernels=[K(name="conv", device=0, duration=30)])
    add = ev("aten::add", 150, 190, kernels=[K(name="add", device=0,
                                                duration=10)])
    events = [window, conv_op, cudnn, add,
              ev(trace.WINDOW, 100, 200, device=cuda),   # device-side mark
              ev("Memcpy HtoD (Pageable -> Device)", 90, 110, device=cuda),
              ev("conv_kernel", 120, 150, device=cuda),
              ev("add_kernel", 140, 160, device=cuda),
              ev("late_kernel", 195, 230, device=cuda)]
    t = trace.reduce(types.SimpleNamespace(events=lambda: events), calls=2)
    assert t.window_us == 100
    # busy: [100, 110] + [120, 160] + [195, 200]
    assert t.busy_us == pytest.approx(55)
    assert t.copy_us() == pytest.approx(10)
    assert t.time_us("kernel") == (pytest.approx(55), 3)   # clipped
    assert t.conv_us == 30
    # idle [110, 120] under the convolution, [160, 195] under aten::add
    assert sorted(t.gaps) == [("aten::add", 35), ("aten::cudnn_convolution",
                                                  10)]
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["aten::add", 35e-6]


def test_mfu_divides_by_the_untraced_call():
    model = dict(MODEL_FULL)
    t = trace.Trace(calls=8, window_us=4e6, busy_us=3e6, device=[],
                    conv_us=0.0, gaps=[], call_s=0.25, model=model,
                    route={"compute_dtype": "bfloat16",
                           "cudnn_allow_tf32": False},
                    traffic={"batch": 2, "route": "train"})
    flops = counts.model_flops(model, 2, True)
    for name in ("mfu.serve", "mfu.train"):
        got = spec.metric_reader(name)(t)
        assert got == pytest.approx(100 * flops / 0.25 / 989e12)
    assert spec.metric_reader("idle_share.train")(t) == pytest.approx(25.0)


@pytest.mark.parametrize("name,kernel,ref,bytes_of", [
    ("k1_roofline.serve", "banded_moments", "s2gp", counts.k1_bytes),
    ("k4_roofline.serve", "projline_sample_kernel", "g2sp", counts.k4_bytes),
    ("k7_roofline.serve", "projline_linemom_kernel", "g2sp",
     counts.k7_bytes)])
def test_roofline_readers_by_hand(name, kernel, ref, bytes_of):
    """A reader's share: the bytes of the traced calls over 3.35 TB/s, over
    the device time of its kernel; silent where the kernel never ran."""
    ref = {"s2gp": s2gp, "g2sp": g2sp}[ref]
    route = {"g2sp_restrict_grid": 1}
    t = trace.Trace(calls=4, window_us=1e6, busy_us=5e5, conv_us=0.0,
                    gaps=[], device=[(f"void {kernel}<4>(...)", 300.0),
                                     (f"{kernel}", 200.0), ("other", 9.0)],
                    model=dict(MODEL_FULL), route=route,
                    traffic={"batch": 2}, reference=ref)
    least = bytes_of({**MODEL_FULL, **route}, 2, ref) * 4 / 3.35e12
    read = spec.metric_reader(name)
    assert read(t) == pytest.approx(100 * least / 500e-6)
    t.device = [("other", 9.0)]
    assert read(t) is None
