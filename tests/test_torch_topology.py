"""PyTorch port, topology builders: the CSR the port builds is the JAX
package's byte for byte (offsets and indices, dtypes included), for all
seven families, so both packages run the same graph."""

from __future__ import annotations

import numpy as np
import pytest

from gossipprotocol_tpu.topology import build_topology as jax_build
from gossipprotocol_tpu_torch.topology import available_topologies
from gossipprotocol_tpu_torch.topology import build_topology as torch_build

_CASES = [
    ("line", 130, {}),
    ("line", 1000, {}),
    ("3D", 216, {}),
    ("3D", 700, {}),
    ("imp3D", 216, {"seed": 4}),
    ("imp3D", 1000, {"seed": 0}),
    ("erdos_renyi", 700, {"seed": 5}),
    ("erdos_renyi", 1000, {"seed": 1, "avg_degree": 3.0}),
    ("power_law", 400, {"seed": 3, "m": 3}),
    ("power_law", 1000, {"seed": 0, "m": 4}),
    ("small_world", 500, {"seed": 2}),
    ("small_world", 1000, {"seed": 7, "k": 4, "beta": 0.3}),
]


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@pytest.mark.parametrize("name,n,kw", _CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in _CASES])
def test_csr_byte_equal(name, n, kw):
    tj = jax_build(name, n, **kw)
    tt = torch_build(name, n, **kw)
    assert (tt.kind, tt.num_nodes, tt.asymmetric) == (
        tj.kind, tj.num_nodes, tj.asymmetric)
    assert _same_bytes(tt.offsets, tj.offsets)
    assert _same_bytes(tt.indices, tj.indices)


def test_full_is_implicit_in_both():
    tj, tt = jax_build("full", 50), torch_build("full", 50)
    assert tt.implicit_full and tj.implicit_full
    assert tt.offsets is None and tt.num_nodes == tj.num_nodes == 50


def test_same_families_and_aliases():
    from gossipprotocol_tpu.topology import available_topologies as jax_av

    assert available_topologies() == jax_av()
    a = torch_build("powerlaw", 300, seed=1, m=2)
    b = torch_build("power-law", 300, seed=1, m=2)
    assert _same_bytes(a.indices, b.indices)
    with pytest.raises(ValueError, match="unknown topology"):
        torch_build("torus", 10)


@pytest.mark.parametrize("name,n,kw", [
    ("erdos_renyi", 700, {"seed": 5}),
    ("erdos_renyi", 400, {"seed": 2, "avg_degree": 2.0}),
    ("imp3D", 216, {"seed": 4}),
])
def test_birth_alive_mask_equal(name, n, kw):
    mj = jax_build(name, n, **kw).birth_alive()
    mt = torch_build(name, n, **kw).birth_alive()
    if mj is None:
        assert mt is None
    else:
        assert np.array_equal(mj, mt) and not mt.flags.writeable
