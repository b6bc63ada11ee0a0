"""Sweep plans: which axes may vary between the lanes of one program (port
of ``gossipprotocol_tpu/sweep/spec.py``; its messages word for word).

The contract that makes a mega-sweep cheap is that every lane shares ONE
compiled chunk program — so a sweep axis may only change *values the
program treats as data*: the PRNG seed (and the gossip seed node it
derives), convergence tolerances, the Poisson activation rate, the
link-loss drop probability. Anything that changes program *structure* —
topology, protocol, delivery plan, predicate, event schedule — is a
different program and is rejected here, loudly, before any device work.

Axis classes:

* ``HOST_AXES``   — consumed on the host while stacking per-lane initial
  state and per-lane base keys (``seed``, ``seed_node``). These never
  appear in the traced program at all, which is why they are the only
  axes the JAX package's sharded sweep takes (the port has no sharded
  sweep yet).
* ``TRACED_AXES`` — threaded through the round cores as per-lane
  ``[B]`` tensors (``eps``, ``tol``, ``threshold``, ``activation_rate``,
  ``drop_prob``). The engine passes unswept parameters as the Python
  constants of the standalone run and swept ones as lane values rounded
  as the standalone run rounds them, so lane *i* stays bitwise equal to
  the standalone run with lane *i*'s config.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
from typing import Any, Dict, Tuple

HOST_AXES = ("seed", "seed_node")
TRACED_AXES = ("eps", "tol", "threshold", "activation_rate", "drop_prob")

# RunConfig / topology knobs that change the compiled program structure.
# Named explicitly so the rejection can say *why* instead of "unknown".
STRUCTURAL_AXES = frozenset({
    "algorithm", "topology", "shape", "kind", "n", "num_nodes", "degree",
    "delivery", "fanout", "predicate", "clock", "workload", "semantics",
    "payload_dim", "value_mode", "accel", "accel_lambda", "groups",
    "streak_target", "edge_chunks", "rounds_per_kernel", "payload_wire",
    "exchange_overlap", "keep_alive", "alert_quorum", "event_plan",
    "fault_plan", "fault_schedule", "repair", "max_rounds", "dtype",
    "local_steps", "sgp_samples",
})

# SGP/GALA training knobs: traced in principle, but the workloads that
# read them are not in the sweep envelope yet.
SGP_AXES = frozenset({"lr", "loss_tol"})

_INT_AXES = frozenset({"seed", "seed_node", "threshold"})


def _check_axis(name: str, values) -> Tuple[Any, ...]:
    if name in SGP_AXES:
        raise ValueError(
            f"sweep axis {name!r}: SGP workloads are not sweepable yet — "
            "lr/loss_tol sweeps need the training state in the lane "
            "envelope; run them serially for now"
        )
    if name in STRUCTURAL_AXES:
        raise ValueError(
            f"structural axis {name!r} cannot vary within a sweep: it "
            "changes the compiled program (topology/protocol/delivery/"
            "event structure is shared by every lane). Sweepable axes: "
            f"{HOST_AXES + TRACED_AXES}"
        )
    if name not in HOST_AXES + TRACED_AXES:
        raise ValueError(
            f"unknown sweep axis {name!r}; sweepable axes: "
            f"{HOST_AXES + TRACED_AXES}"
        )
    if not isinstance(values, (list, tuple)) or len(values) == 0:
        raise ValueError(
            f"sweep axis {name!r} needs a non-empty list of values"
        )
    out = []
    for v in values:
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(
                f"sweep axis {name!r}: value {v!r} is not a number"
            )
        if name in _INT_AXES:
            if int(v) != v:
                raise ValueError(
                    f"sweep axis {name!r}: value {v!r} must be an integer"
                )
            v = int(v)
            if name == "threshold" and v < 1:
                raise ValueError("sweep axis 'threshold': values must be >= 1")
            if name == "seed_node" and v < 0:
                raise ValueError("sweep axis 'seed_node': values must be >= 0")
        else:
            v = float(v)
            if not math.isfinite(v):
                raise ValueError(
                    f"sweep axis {name!r}: value {v!r} is not finite"
                )
            if name == "drop_prob" and not 0.0 <= v < 1.0:
                raise ValueError(
                    "sweep axis 'drop_prob': values must be in [0, 1) — "
                    "prob 1.0 drops every message forever"
                )
            if name in ("eps", "tol") and v <= 0.0:
                raise ValueError(f"sweep axis {name!r}: values must be > 0")
            if name == "activation_rate" and v <= 0.0:
                raise ValueError(
                    "sweep axis 'activation_rate': rates must be > 0"
                )
        out.append(v)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A validated sweep plan: named axes of lane values.

    ``mode='product'`` (default) crosses the axes (B = Π lengths);
    ``mode='zip'`` pairs them positionally (all axes must share one
    length). Lane order is the natural iteration order of the mode, so
    ``lane_config(cfg, i)`` is deterministic and documented: lane *i* of
    a sweep IS the standalone run with that config.
    """

    axes: Tuple[Tuple[str, Tuple[Any, ...]], ...]
    mode: str = "product"

    def __post_init__(self):
        if not self.axes:
            raise ValueError(
                "sweep plan declares no axes — nothing to sweep"
            )
        if self.mode not in ("product", "zip"):
            raise ValueError("sweep mode must be 'product' or 'zip'")
        seen = set()
        checked = []
        for name, values in self.axes:
            if name in seen:
                raise ValueError(f"sweep axis {name!r} declared twice")
            seen.add(name)
            checked.append((name, _check_axis(name, values)))
        object.__setattr__(self, "axes", tuple(checked))
        if self.mode == "zip":
            lengths = {len(v) for _, v in self.axes}
            if len(lengths) > 1:
                raise ValueError(
                    "sweep mode 'zip' needs equal-length axes; got "
                    + ", ".join(f"{n}={len(v)}" for n, v in self.axes)
                )
        if self.lanes < 1:
            raise ValueError("sweep needs at least one lane (B >= 1)")

    # ---- constructors --------------------------------------------------

    @classmethod
    def from_plan(cls, doc: Any) -> "SweepSpec":
        """Build from a parsed plan document ``{"axes": {...}, "mode"?}``.

        A bare axes mapping (no ``"axes"`` key) is accepted as sugar.
        """
        if not isinstance(doc, dict):
            raise ValueError(
                "sweep plan must be a JSON object with an 'axes' mapping"
            )
        body = doc.get("axes", doc if "mode" not in doc else None)
        if not isinstance(body, dict):
            raise ValueError("sweep plan 'axes' must be a mapping")
        unknown = set(doc) - {"axes", "mode"}
        if "axes" in doc and unknown:
            raise ValueError(
                f"sweep plan has unknown key(s) {sorted(unknown)}; "
                "expected 'axes' and optional 'mode'"
            )
        return cls(
            axes=tuple((str(k), tuple(v) if isinstance(v, (list, tuple))
                        else v) for k, v in body.items()),
            mode=str(doc.get("mode", "product")),
        )

    @classmethod
    def from_file(cls, path: str) -> "SweepSpec":
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as e:
            raise ValueError(f"cannot read sweep plan {path!r}: {e}") from e
        except json.JSONDecodeError as e:
            raise ValueError(f"sweep plan {path!r} is not valid JSON: {e}") from e
        return cls.from_plan(doc)

    @classmethod
    def from_seeds(cls, count: int, base_seed: int = 0) -> "SweepSpec":
        """``--sweep-seeds N`` sugar: seeds base, base+1, ... base+N-1."""
        if count < 1:
            raise ValueError("sweep needs at least one lane (B >= 1)")
        return cls(axes=(
            ("seed", tuple(base_seed + i for i in range(count))),
        ))

    # ---- lane expansion ------------------------------------------------

    @property
    def lanes(self) -> int:
        if self.mode == "zip":
            return len(self.axes[0][1])
        b = 1
        for _, values in self.axes:
            b *= len(values)
        return b

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def traced_names(self) -> Tuple[str, ...]:
        return tuple(n for n in self.axis_names if n in TRACED_AXES)

    def lane_overrides(self, lane: int) -> Dict[str, Any]:
        """Axis values for lane ``lane`` in documented lane order."""
        if not 0 <= lane < self.lanes:
            raise IndexError(f"lane {lane} out of range for {self.lanes}")
        if self.mode == "zip":
            return {name: values[lane] for name, values in self.axes}
        combo = next(itertools.islice(
            itertools.product(*(v for _, v in self.axes)), lane, None))
        return dict(zip(self.axis_names, combo))

    def lane_config(self, cfg, lane: int):
        """The standalone :class:`RunConfig` lane ``lane`` must equal.

        ``drop_prob`` rewrites the (single) loss window's probability —
        synthesizing a whole-run window when the base schedule has none;
        ``activation_rate`` requires ``clock='poisson'`` on the template.
        """
        over = dict(self.lane_overrides(lane))
        drop = over.pop("drop_prob", None)
        if "activation_rate" in over and cfg.clock != "poisson":
            raise ValueError(
                "sweep axis 'activation_rate' needs --clock poisson on "
                "the base config (the sync clock compiles activation out)"
            )
        if drop is not None:
            from gossipprotocol_tpu_torch.utils.faults import (
                FaultSchedule, LossWindow,
            )

            sched = cfg.schedule
            if len(sched.loss) > 1:
                raise ValueError(
                    "sweep axis 'drop_prob' needs at most one loss window "
                    f"on the base config (got {len(sched.loss)}) — it "
                    "rewrites that window's probability per lane"
                )
            window = (sched.loss[0] if sched.loss
                      else LossWindow(0, cfg.max_rounds, 0.0))
            over["fault_schedule"] = FaultSchedule(
                kills=sched.kills, revives=sched.revives,
                loss=(LossWindow(window.start, window.stop, float(drop)),),
            )
            over["fault_plan"] = None
        return dataclasses.replace(cfg, **over)

    def describe(self) -> dict:
        """JSON-able summary for telemetry / manifests."""
        return {
            "mode": self.mode,
            "lanes": self.lanes,
            "axes": {name: list(values) for name, values in self.axes},
        }
