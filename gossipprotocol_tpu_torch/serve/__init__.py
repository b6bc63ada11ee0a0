"""The serve daemon's host-side records (port of the readers of
``gossipprotocol_tpu/serve``).

* :mod:`.journal`   — queue-dir layout + the append-only state journal
  every request transition lands in, and its replay into per-request
  states;
* :mod:`.lifecycle` — journal events as Perfetto spans, and the live
  progress of a running request's telemetry dir.

``watch --queue-dir`` and ``history`` read these. The daemon itself
(admission, the supervisor loop, the per-request worker, ``submit`` and
``status``) is not ported yet.
"""

from gossipprotocol_tpu_torch.serve.journal import (  # noqa: F401
    Journal, QueuePaths,
)
