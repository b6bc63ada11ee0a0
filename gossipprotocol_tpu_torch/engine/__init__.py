from gossipprotocol_tpu_torch.engine.driver import (
    ALGORITHMS,
    NotPortedError,
    RunConfig,
    RunResult,
    build_protocol,
    make_chunk_runner,
    resume_simulation,
    run_simulation,
)

__all__ = [
    "ALGORITHMS",
    "NotPortedError",
    "RunConfig",
    "RunResult",
    "build_protocol",
    "make_chunk_runner",
    "resume_simulation",
    "run_simulation",
]
