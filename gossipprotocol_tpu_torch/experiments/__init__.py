"""The reference's curve tools over the port (copies of
``gossipprotocol_tpu/experiments``): ``curves`` sweeps the Report.pdf
grid through :func:`~gossipprotocol_tpu_torch.run_simulation`,
``oracle_curves`` the event-driven oracle (``native.py``, on the host)."""
