"""The JAX package's closed-form capacity figure beside the PyTorch port's
model, for each (q4) run of ``chip_smoke.py`` (a helper of the capacity
tests, not collected by pytest; host only, no device):

    JAX_PLATFORMS=cpu python tests/capacity_figures.py

builds each (q4) graph with the port's builders (seed 0, ``--attach 4``)
and prints, per run, the port's ``estimate_for_topology`` total and the
JAX package's ``estimate_run_bytes`` total at the same exact edge count
and max degree. The card's measured peaks are ``chip_smoke.py`` (q4)'s.
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import chip_smoke
    from gossipprotocol_tpu import RunConfig as JRunConfig
    from gossipprotocol_tpu.obs import capacity as jcap
    from gossipprotocol_tpu.sweep import SweepSpec as JSpec

    from gossipprotocol_tpu_torch.engine.driver import RunConfig
    from gossipprotocol_tpu_torch.obs.capacity import estimate_for_topology
    from gossipprotocol_tpu_torch.sweep import SweepSpec
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = None
    for label, kind, n, kw, shards in chip_smoke.CAPACITY_RUNS:
        if topo is None or (topo.kind, topo.num_nodes) != (kind, n):
            topo = build_topology(kind, n, seed=0, m=4)
        cfg = RunConfig(**kw, device="cuda",
                        max_rounds=chip_smoke.CAPACITY_ROUNDS)
        jkw = {k: v for k, v in kw.items()}
        jcfg = JRunConfig(**jkw, max_rounds=chip_smoke.CAPACITY_ROUNDS)
        if "sweep" in label:
            cfg = dataclasses.replace(
                cfg, sweep=SweepSpec.from_seeds(chip_smoke.SWEEP_LANES))
            jcfg = dataclasses.replace(
                jcfg, sweep=JSpec.from_seeds(chip_smoke.SWEEP_LANES))
        port = estimate_for_topology(topo, cfg, shards)["per_device"]
        max_deg = int(topo.degree.max())
        ref = jcap.estimate_run_bytes(
            kind, n, jcfg, shards, num_edges=int(topo.num_directed_edges),
            max_degree=max_deg, implicit_full=bool(topo.implicit_full))
        print(f"{label} {kind} {n}: port {port['total_bytes']} B, JAX "
              f"closed form {ref['per_device']['total_bytes']} B "
              f"(x{shards} shards on one card: "
              f"{ref['per_device']['total_bytes'] * shards} B)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
