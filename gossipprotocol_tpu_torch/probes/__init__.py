"""The measurement probes, ported: ``slab_probe``, ``route_probe`` and
``tile_perm_probe`` (the JAX package's ``experiments/*_probe.py``).

Each runs as ``python -m gossipprotocol_tpu_torch.probes.<name>`` on the
card by default (``--device cpu`` runs the kernels' plain versions),
prints one line per measurement (name, ms, GB/s, with the JAX scripts'
byte counts) and each kernel's result against its plain version. A
kernel that fails to build, to launch or to match ends the probe with a
non-zero exit: nothing is caught and passed over.

Timing: R = 32 calls, best of 3, after warm-up. On the card the R calls
are captured once into a CUDA graph and each replay is timed with CUDA
events: device time without the host's per-call enqueue, the counterpart
of the JAX probes' R iterations inside one jitted dispatch. On the CPU,
the host clock around R calls.
"""

from __future__ import annotations

import time

import torch

R = 32


class ProbeMismatch(RuntimeError):
    """A kernel's output differs from its plain version."""


def seconds_per_call(fn, device: torch.device, repeats: int = 3) -> float:
    """Best of ``repeats`` mean times of R calls of ``fn``, in seconds (on
    the card: replays of one CUDA graph of the R calls)."""
    fn()
    if device.type == "cuda":
        return _graph_seconds(fn, device, repeats)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(R):
            fn()
        best = min(best, (time.perf_counter() - t0) / R)
    return best


def _graph_seconds(fn, device: torch.device, repeats: int) -> float:
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # where fn warmed up
        for _ in range(R):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats + 1):   # the first replay uploads the graph
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3 / R)
    del graph
    torch.cuda.empty_cache()
    return best


def report(name: str, secs: float, nbytes: float) -> None:
    """One measurement line: name, ms per call, GB/s."""
    print(f"{name:52s} {secs * 1e3:9.4f} ms  {nbytes / secs / 1e9:8.1f} GB/s",
          flush=True)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def check_plain(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Print the kernel's result against its plain version; raise on any
    differing bit."""
    if not bitwise_equal(got, want):
        raise ProbeMismatch(f"{name}: kernel output differs from its plain "
                            "version")
    if got.device.type == "cuda":
        print(f"  {name}: kernel == plain version, bitwise "
              f"({got.numel()} values)", flush=True)
    else:
        print(f"  {name}: plain version on the cpu ({got.numel()} values; "
              "the kernel runs on the card only)", flush=True)


def device_line(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
