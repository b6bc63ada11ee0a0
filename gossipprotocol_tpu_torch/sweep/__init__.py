"""Batched sweeps: B independent runs through one round program (port of
``gossipprotocol_tpu/sweep``, single card).

A :class:`SweepSpec` expands axes that vary only *values the round
treats as data* (seeds, tolerances, activation rates, drop probabilities)
into per-lane state with a leading ``[B]`` lane dimension that rides the
port's own chunk runner — one delivery build, one fetch a chunk, B lanes.
Structural axes (topology, shape, protocol, delivery, event plans) are
rejected loudly: they change the round and belong in separate sweeps.
"""

from gossipprotocol_tpu_torch.sweep.spec import (  # noqa: F401
    HOST_AXES,
    SGP_AXES,
    STRUCTURAL_AXES,
    TRACED_AXES,
    SweepSpec,
)

__all__ = [
    "SweepSpec",
    "HOST_AXES",
    "TRACED_AXES",
    "STRUCTURAL_AXES",
    "SGP_AXES",
    "run_sweep",
    "SweepConfigError",
    "SweepResult",
]


def __getattr__(name):  # lazy: spec parsing must not import the engine
    if name in ("run_sweep", "SweepResult", "SweepConfigError"):
        from gossipprotocol_tpu_torch.sweep import engine

        return getattr(engine, name)
    raise AttributeError(name)
