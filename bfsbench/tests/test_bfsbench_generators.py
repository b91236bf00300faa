"""The frozen generators equal the port's streams they were copied from."""

from __future__ import annotations

import numpy as np
import pytest

from bfsbench.graphs import urand
from bfsbench.tests.conftest import gxx_builds


@pytest.mark.parametrize("scale,seed", [(10, 1), (12, 2**33 + 7)])
def test_kronecker_copy_is_bit_equal_to_the_native_stream(scale, seed, cache_root):
    from tpu_bfs_torch.graph.generate import rmat_edges
    from tpu_bfs_torch.utils.native import has_rmat

    if not gxx_builds(cache_root):
        pytest.skip("g++ cannot build the frozen Kronecker generator here")
    if not has_rmat():
        pytest.skip("the port's native library does not build here")
    from bfsbench.graphs import kronecker

    params = {"scale": scale, "edge_factor": 16, "seed": seed, "a": 0.57, "b": 0.19, "c": 0.19}
    u, v = kronecker.edges(params, cache_root / "native")
    pu, pv = rmat_edges(scale, 16, seed=seed, impl="native")
    np.testing.assert_array_equal(u, pu)
    np.testing.assert_array_equal(v, pv)


def test_urand_copy_equals_random_graph(cache_root):
    from tpu_bfs_torch.graph.generate import random_graph
    from tpu_bfs_torch.graph.io import from_edges

    params = {"scale": 11, "edge_factor": 16, "seed": 9}
    u, v = urand.edges(params, cache_root / "native")
    mine = from_edges(u, v, num_vertices=1 << 11, directed=False)
    theirs = random_graph(1 << 11, 16 << 11, seed=9)
    np.testing.assert_array_equal(mine.row_ptr, theirs.row_ptr)
    np.testing.assert_array_equal(mine.col_idx, theirs.col_idx)
