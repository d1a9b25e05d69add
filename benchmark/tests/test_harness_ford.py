"""The Ford family (``reference/ford.py``) against the port's
``LMS2GPFord`` on the CPU at a small size, under the Ford data's
front-left rig: a 128-pixel patch (28.16 m at 0.22 m a pixel), a 64 x 256
ground input and two iterations, where the rig's kept rows stay in the
patch and the pose moves.  Also the layout each rig takes, the
configuration's files, the reference's imports, the solver's projection
span and its reader ``project_ms.serve``, K1's roofline on Ford's
footprint, a Ford training step's rig given once, and, on the card, the
banded kernels' launches in the unswapped layout.

Tolerances, and why:
* trajectories on the banded rule, bf16 or float32 map: the first round
  within 1e-6 in normalized pose (measured at most 1.6e-8 on three
  inputs), every round within 2e-3 (measured at most 6.4e-4): the two
  sides form each row's satellite line from its first two points in
  another order of float32 operations, and the line's slope times up to
  255 columns moves the cell of a few samples by an ulp; from the finest
  level of the first iteration on (round 3) the rounds carry that on
  (1e-5 to 6.4e-4 there, against 1e-6 in rounds 1-2);
* on the gather rule, where every pixel is projected alike on both
  sides: 1e-5 over every round (measured 3.0e-8);
* a training step: the loss within 1e-4 of itself, each leaf's gradient
  within 5% of its norm (the banded map gradient sums in another order,
  and the solver's feature gradients move as the S2GP twin's do).
"""

import ast
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import counts, runner, spec, trace
from benchmark.reference import ford
from benchmark.tests._tiny import tiny_cell

SIZES = dict(sat_size=128, grd_h=64, grd_w=256, N_iters=2,
             shift_range_lat=20.0, shift_range_lon=20.0,
             rotation_range=10.0, damping=0.1)
B = 3
# bench.py's Ford rig (the port's ``bench.FORD_QVEC``): near identity
BENCH_QVEC = (0.997, 0.01, 0.05, 0.02)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_model(**kw):
    from highlyaccurate_tpu_torch import Config
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.params import init_params
    cfg = Config(grd_h=64, grd_w=256, sat_size=128, N_iters=2, **kw)
    m = LMS2GPFord(cfg, device="cpu")
    init_params(m, torch.Generator().manual_seed(0))
    return m, {k: v.detach().clone() for k, v in m.state_dict().items()}


def images(n=B, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, 128, 128, 3, generator=g),
            torch.rand(n, 64, 256, 3, generator=g))


def rig(n=B):
    R, T = ford.rig()
    return (torch.from_numpy(np.repeat(R[None], n, 0)),
            torch.from_numpy(np.repeat(T[None], n, 0)))


def draws(n, rounds=6, seed=5):
    gen = torch.Generator().manual_seed(seed)
    out = [torch.rand((2, n), generator=gen) * 2 - 1 for _ in range(rounds)]
    return lambda t: out[t]


@pytest.mark.parametrize("dtype,bf16_map,banded,rule,tol", [
    ("bfloat16", 1, 1, "line", 2e-3), ("float32", 0, 1, "line", 2e-3),
    ("float32", 0, 0, "gather", 1e-5)])
def test_ford_trajectory_matches_the_port(dtype, bf16_map, banded, rule,
                                          tol):
    m, sd = port_model(compute_dtype=dtype, banded_bf16_map=bf16_map,
                       use_banded_warp=banded)
    sat, grd = images()
    with torch.no_grad():
        lat, lon, th = m(sat, grd, ford.side_m(SIZES), *rig(),
                         mode="trajectory",
                         generator=torch.Generator().manual_seed(5))
        ref = ford.trajectory(sd, sat, grd,
                              dict(SIZES, banded_bf16_map=bf16_map),
                              draws(B), dtype, rule)
    gap = (torch.stack([lat, lon, th], -1) - ref).abs()
    assert gap[:, 0, 0].max() < 1e-6 and gap.max() < tol
    # the pose moves, inside the re-init range (the draws agree anyway)
    assert ref[:, -1].abs().max() > 1e-2 and ref.abs().max() < 2.5


def test_ford_training_gradients_match_the_port():
    m, sd = port_model(compute_dtype="float32", test=0)
    m.train()
    sat, grd = images(4)
    gt = torch.rand(4, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    out = m(sat, grd, ford.side_m(SIZES), *rig(4), mode="train",
            gt_pose=gt, generator=torch.Generator().manual_seed(5))
    out.loss.backward()
    theta = {k: v.requires_grad_(True) for k, v in sd.items()}
    loss = ford.loss(ford.trajectory(theta, sat, grd,
                                     dict(SIZES, banded_bf16_map=1),
                                     draws(4), "float32", "line"),
                     gt).mean()
    loss.backward()
    assert abs(loss.item() - out.loss.item()) < 1e-4 * out.loss.item()
    for name, p in m.named_parameters():
        ref = theta[name].grad
        assert (p.grad is None) == (ref is None), name
        if ref is not None:
            assert (p.grad - ref).norm() <= 0.05 * ref.norm(), name


@pytest.mark.parametrize("qvec,swap", [(ford.RIG_QVEC, False),
                                       (BENCH_QVEC, True)])
def test_each_rig_takes_its_layout(qvec, swap):
    """The data's rig samples in the unswapped layout, bench.py's in the
    JAX one, on both sides."""
    from highlyaccurate_tpu_torch import bench
    from highlyaccurate_tpu_torch.geometry.ford import (qvec2rotmat,
                                                        sample_layouts)
    assert tuple(bench.FORD_QVEC) == BENCH_QVEC
    assert ford.swapped(ford.rotation(qvec)) == swap
    assert sample_layouts(qvec2rotmat(qvec)[None]).tolist() == [swap]


def test_the_ford_configuration_resolves():
    for workload in ("ford-serve-b128", "ford-train-b16"):
        cell = spec.resolve(workload)
        assert cell.reference.__file__ == str(spec.HERE / "reference"
                                              / "ford.py")
        assert cell.chips == 1
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    (entry,) = [c for c in bench["configs"] if c["name"] == "ford"]
    assert entry["reduced"] == []
    model = spec.load_json(spec.ROOT / entry["file"])["model"]
    assert model == spec.load_json(spec.HERE / "configs" / "s2gp.json")[
        "model"]      # the Ford CLI's defaults are KITTI's, widths and all
    assert ford.side_m(model) == pytest.approx(112.64)


def test_the_ford_reference_imports_neither_package_nor_jax():
    for name in ("ford", "s2gp", "vgg"):
        tree = ast.parse((spec.HERE / "reference" / f"{name}.py")
                         .read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert set(roots) <= {"__future__", "functools", "itertools",
                                  "math", "numpy", "torch", "benchmark"}, (
                name, roots)
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.ford;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
            "'jaxlib', 'flax', 'highlyaccurate_tpu', "
            "'highlyaccurate_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_ford_footprint_is_the_data_rigs():
    """K1's bytes read Ford's zero-pose footprint at the cell's own size:
    the kept rows of the data's rig touch fewer cells than KITTI's, and
    never more than the map holds."""
    from benchmark.reference import s2gp
    cfg = {**spec.resolve("ford-serve-b128").config["model"]}
    cells = ford.map_cells(cfg)
    assert cells == (205, 848, 3490)
    assert all(n < k <= A * A for n, k, (A, _, _, _) in zip(
        cells, s2gp.map_cells(cfg), counts.levels(cfg)))
    assert counts.k1_bytes(cfg, 128, ford) == 9904168960.0


@pytest.mark.parametrize("family", ("ford", "kitti"))
def test_the_projection_span_records_once_a_round(family):
    from highlyaccurate_tpu_torch.utils import profiling
    profiling.reset_spans()
    profiling.enable_spans(True)
    try:
        sat, grd = images(2)
        with torch.no_grad():
            if family == "ford":
                m, _ = port_model()
                m(sat, grd, ford.side_m(SIZES), *rig(2),
                  generator=torch.Generator().manual_seed(5))
            else:
                from highlyaccurate_tpu_torch import Config
                from highlyaccurate_tpu_torch.models.lm_s2gp import LMS2GP
                m = LMS2GP(Config(grd_h=64, grd_w=256, sat_size=128,
                                  N_iters=2), device="cpu")
                m(sat, grd, generator=torch.Generator().manual_seed(5))
        table = profiling.span_table()
    finally:
        profiling.enable_spans(False)
        profiling.reset_spans()
    assert table["hat.solver.project"].count == 2 * 3
    assert table["hat.solver.project"].count == sum(
        v.count for k, v in table.items()
        if k.startswith("hat.solver.round.l"))


def _trace(calls, **kw):
    return trace.Trace(calls=calls, window_us=1e6, busy_us=5e5, conv_us=0.0,
                       gaps=[], **kw)


def test_project_ms_reads_the_projection_spans_device_time(monkeypatch):
    """``project_ms.serve``: device ms of ``hat.solver.project`` a traced
    call; silent without the span (the parent's program) and on spans of
    a process without CUDA."""
    from highlyaccurate_tpu_torch.utils import profiling
    from highlyaccurate_tpu_torch.utils.profiling import SpanStats
    read = spec.metric_reader("project_ms.serve")
    for rows, want in (
            ({"hat.solver.project": SpanStats(60, 0.4, 0.1, 60),
              "hat.solver": SpanStats(4, 2.0, 0.6, 4)}, 25.0),
            ({"hat.solver": SpanStats(4, 2.0, 0.6, 4)}, None),
            ({"hat.solver.project": SpanStats(60, 0.4, 0.0, 0)}, None)):
        monkeypatch.setattr(profiling, "span_table", lambda: dict(rows))
        got = read(_trace(4, device=[]))
        assert got == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "span_table")
    assert read(_trace(4, device=[])) is None


def test_the_k1_roofline_counts_fords_footprint():
    """``k1_roofline.serve`` in a Ford cell: the bytes of Ford's zero-pose
    footprint (``ford.map_cells``) over 3.35 TB/s, over K1's device time;
    silent where K1 never ran."""
    model = dict(SIZES, banded_bf16_map=1)
    t = _trace(4, device=[("void banded_moments<4>(...)", 300.0),
                          ("banded_moments", 200.0), ("other", 9.0)],
               model=model, route={}, traffic={"batch": 2}, reference=ford)
    least = counts.k1_bytes(model, 2, ford) * 4 / 3.35e12
    read = spec.metric_reader("k1_roofline.serve")
    assert read(t) == pytest.approx(100 * least / 500e-6)
    t.device = [("other", 9.0)]
    assert read(t) is None


def test_a_ford_step_takes_the_rig_once_as_it_takes_it_per_image():
    """``make_train_step(ford_extrinsics=)``, the harness's form, trains
    as a step handed every image's rig; the rig needs the patch's side."""
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    sat, grd = images(4)
    gt = torch.rand(4, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    out = []
    for bound in (True, False):
        m, _ = port_model(compute_dtype="float32", test=0)
        m.train()
        kw = dict(ford_extrinsics=ford.rig()) if bound else {}
        step = make_train_step(m, m.cfg, ford_side_m=ford.side_m(SIZES),
                               **kw)
        extras = () if bound else rig(4)
        _, metrics = step(create_train_state(m.cfg, m), sat, grd, *extras,
                          gt, torch.Generator().manual_seed(5))
        out.append((metrics["loss"], [p.detach() for p in m.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    with pytest.raises(ValueError, match="ford_side_m"):
        make_train_step(m, m.cfg, ford_extrinsics=ford.rig())


def test_the_unswapped_layout_is_read_from_the_map_view():
    from highlyaccurate_tpu_torch.ops.banded_warp import unswapped_layout
    sat = torch.zeros(2, 16, 16, 8)
    assert unswapped_layout(sat)
    assert not unswapped_layout(sat.transpose(1, 2))


@pytest.mark.cuda
def test_ford_launches_take_the_unswapped_layout_on_the_card():
    """A Ford call launches K1 once a round, a Ford step K2 and K3 once a
    round, all in the unswapped layout; KITTI's in the other."""
    if not torch.cuda.is_available():
        pytest.skip("the banded kernels run only on the card")
    from highlyaccurate_tpu_torch import Config, ops
    from highlyaccurate_tpu_torch.inference import Localizer
    from highlyaccurate_tpu_torch.models.ford import LMS2GPFord
    from highlyaccurate_tpu_torch.train.state import create_train_state
    from highlyaccurate_tpu_torch.train.step import make_train_step
    cfg = Config(grd_h=64, grd_w=256, sat_size=128, N_iters=2)
    sat, grd = images(2)
    R, T = ford.rig()
    loc = Localizer(cfg, random_init=True, batch_size=2, device="cuda",
                    ford_extrinsics=(R, T), ford_side_m=ford.side_m(SIZES))
    ops.reset_launches()
    loc.predict(sat.numpy(), grd.numpy())
    assert ops.expect_launches("a Ford call", {"k1": 6})
    assert ops.unswapped_launch_counts() == {"k1": 6, "k2": 0, "k3": 0}

    model = LMS2GPFord(Config(grd_h=64, grd_w=256, sat_size=128, N_iters=2,
                              compute_dtype="float32", test=0),
                       device="cuda")
    model.train()
    step = make_train_step(model, model.cfg, ford_side_m=ford.side_m(SIZES),
                           ford_extrinsics=ford.rig())
    state = create_train_state(model.cfg, model)
    ops.reset_launches()
    step(state, sat.cuda(), grd.cuda(), torch.zeros(2, 3, device="cuda"),
         torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    ops.expect_launches("a Ford step", {"k2": 6, "k3": 6})
    assert ops.unswapped_launch_counts() == {"k1": 0, "k2": 6, "k3": 6}

    kitti = Localizer(cfg, random_init=True, batch_size=2, device="cuda")
    ops.reset_launches()
    kitti.predict(sat.numpy(), grd.numpy())
    ops.expect_launches("a KITTI call", {"k1": 6})
    assert ops.unswapped_launch_counts() == {"k1": 0, "k2": 0, "k3": 0}
