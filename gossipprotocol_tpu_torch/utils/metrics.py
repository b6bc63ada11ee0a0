"""The reference's output lines (copy of ``print_start_banner`` and
``print_convergence_time`` from ``gossipprotocol_tpu/utils/metrics.py``),
format-compatible with the F# simulator's ``printfn`` lines."""

from __future__ import annotations

import sys
from typing import IO, Optional


def print_start_banner(algorithm: str, stream: Optional[IO] = None) -> None:
    """Reference start banners: "Gossip Starts" / "Push Sum Starts"
    (``Program.fs:198,204``)."""
    stream = stream or sys.stdout
    print("Gossip Starts" if algorithm == "gossip" else "Push Sum Starts",
          file=stream)


def print_convergence_time(wall_ms: float, stream: Optional[IO] = None) -> None:
    """The reference's single output metric, ``printfn "Convergence Time:
    %f ms"`` (``Program.fs:55``)."""
    stream = stream or sys.stdout
    print(f"Convergence Time: {wall_ms:f} ms", file=stream)
