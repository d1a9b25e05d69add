"""Device ms per served batch of the kept rows' projection: the program's
``hat.solver.project`` spans (each round's satellite lines and their
Jacobian, through KITTI's ground plane or the Ford rig's camera -> body
-> world -> satellite chain), the stream time between each span's entry
and its exit, idle inside included."""

from benchmark.harness import spans


def read(t):
    return spans.ms_per_call(t, ("hat.solver.project",), "device")
