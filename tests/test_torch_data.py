"""The port's community_small and grid generators against the JAX
package's.

``ccsd_tpu_torch.data.loader.community_small_adjs(num, seed)`` and
``grid_adjs(num, seed, ...)`` replicate ``np.random.seed(seed)`` followed by
``gen_graph_list("community", ...)`` and ``gen_graph_list("grid", ...)``
(ccsd_tpu/data/generators.py:196-225) with numpy and the standard library
only; the graphs must be equal bit for bit once padded to the config's N
as the JAX package pads them (``graphs_to_tensor``).
"""

import numpy as np
import pytest

from ccsd_tpu.data import generators
from ccsd_tpu.data.cc_codec import graphs_to_tensor

from ccsd_tpu_torch.data.loader import (
    GENERATED,
    community_small_adjs,
    generated_adjs,
    grid_adjs,
    n_community,
)


@pytest.fixture
def global_np_random():
    """The JAX recipe draws from numpy's global state: restore it after."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024])
def test_community_small_equals_gen_graph_list(seed, global_np_random):
    np.random.seed(seed)
    graphs = generators.gen_graph_list(
        "community", {"num_communities": [2], "max_nodes": np.arange(12, 21).tolist()},
        length=100)
    want = graphs_to_tensor(graphs, 20)
    got = community_small_adjs(100, seed)
    assert got.shape == want.shape == (100, 20, 20) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_communities,max_nodes", [(2, 4), (2, 7), (2, 11), (3, 9),
                                                       (3, 12), (4, 8)])
def test_n_community_equals_the_jax_recipe(num_communities, max_nodes, global_np_random):
    """Small communities come out of G(c, 0.7) disconnected, so the bridges
    run over more than two components, each in the node order of networkx's
    subgraph view; the global state must also end where the JAX recipe
    leaves it."""
    np.random.seed(3)
    g = generators.n_community(num_communities, max_nodes)
    want = graphs_to_tensor([g], g.number_of_nodes())[0]
    after = np.random.random_sample()
    rs = np.random.RandomState(3)
    np.testing.assert_array_equal(n_community(rs, num_communities, max_nodes), want)
    assert rs.random_sample() == after


# (m and n ranges, N) of grid_small and grid (generators.py:206-225)
GRID_RECIPES = {"grid_small": (np.arange(4, 8).tolist(), 49),
                "grid": (np.arange(10, 20).tolist(), 361)}


@pytest.mark.parametrize("seed", [0, 3, 42])
@pytest.mark.parametrize("name", list(GRID_RECIPES))
def test_grid_equals_gen_graph_list(name, seed, global_np_random):
    """m, then n, one np.random.choice each; nodes (i, j) numbered row-major;
    100 graphs, as generate_dataset makes them."""
    sizes, N = GRID_RECIPES[name]
    np.random.seed(seed)
    graphs = generators.gen_graph_list("grid", {"m": sizes, "n": sizes}, length=100)
    want = graphs_to_tensor(graphs, N)
    got = grid_adjs(100, seed, N, sizes, sizes)
    assert got.shape == want.shape == (100, N, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(generated_adjs(name, seed, N), want)
    # and the global state ends where the JAX recipe leaves it
    after = np.random.random_sample()
    rs = np.random.RandomState(seed)
    grid_adjs(100, rs, N, sizes, sizes)
    assert rs.random_sample() == after


def test_generated_datasets_are_the_jax_recipes():
    assert set(GENERATED) == {"community_small", "community_small_CC", "grid_small",
                              "grid_small_CC", "grid"}
    np.testing.assert_array_equal(generated_adjs("community_small", 7, 20),
                                  community_small_adjs(100, 7, 20))
    # the CC dataset's graphs are community_small's (their lift: test_torch_cc_ops.py)
    np.testing.assert_array_equal(generated_adjs("community_small_CC", 7, 20),
                                  community_small_adjs(100, 7, 20))
    np.testing.assert_array_equal(generated_adjs("grid_small_CC", 7, 49),
                                  generated_adjs("grid_small", 7, 49))
    with pytest.raises(ValueError, match="max_node_num=20"):
        grid_adjs(1, 0, 20, [5], [5])
