"""Native C++ component tests: JSON parser + tree preprocessor."""

import json
import os
import time

import numpy as np
import pytest

from tests.conftest import fixture_path, requires_reference


@pytest.fixture(scope="module")
def native_lib():
    from rapidnet_jax.native import get_lib
    lib = get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain available")
    return lib


@requires_reference
def test_native_json_matches_stdlib(native_lib):
    from rapidnet_jax.native import jsonfast
    for name in ("network.json", "scenarioTree.json",
                 "controllerConfig.json"):
        path = fixture_path(name)
        ref = json.load(open(path))
        mine = jsonfast.load(path)
        assert list(mine.keys()) == list(ref.keys()), name
        for k, v in ref.items():
            if isinstance(v, list):
                np.testing.assert_allclose(
                    np.asarray(mine[k], np.float64),
                    np.asarray(v, np.float64), rtol=1e-12,
                    err_msg=f"{name}:{k}")
            else:
                assert mine[k] == v, f"{name}:{k}"


def test_native_json_speed(native_lib, tmp_path):
    """Native parser beats stdlib json on a MB-scale tree file."""
    from rapidnet_jax.native import jsonfast
    big = {"N": [24], "vals": np.random.default_rng(0)
           .standard_normal(400_000).round(6).tolist()}
    path = str(tmp_path / "big.json")
    json.dump(big, open(path, "w"))

    t0 = time.perf_counter()
    a = json.load(open(path))
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = jsonfast.load(path)
    t_cc = time.perf_counter() - t0
    np.testing.assert_allclose(a["vals"][:100], b["vals"][:100])
    assert t_cc < t_py * 1.2, (t_cc, t_py)  # at least competitive


def test_native_tree_prefix_agg(native_lib):
    """C++ prefix-aggregation builder == the per-slot Python definition."""
    from rapidnet_jax.model.scenario_tree import generate_tree
    tree = generate_tree(N=10, branching=[3, 2, 2], nd=4, nu=6, seed=11)
    assert tree.prefix_agg, "tree should have branching prefix stages"
    for s, C in tree.prefix_agg.items():
        parent_of_slot = tree.ancestor[tree.node_of_slot[s]]
        Cref = np.zeros_like(C)
        for i in range(tree.ns):
            mask = ((parent_of_slot == tree.node_of_slot[s - 1, i]) &
                    (tree.rep[s] > 0))
            Cref[i, mask] = 1.0
        np.testing.assert_array_equal(C, Cref, err_msg=f"stage {s}")
        # each representative stage-s slot is claimed by exactly the
        # slots of its parent node (one contiguous duplicated run)
        reps = tree.rep[s] > 0
        claims = C.sum(0)[reps]
        assert (claims >= 1).all() and (claims == claims).all()
        # restricted to representative parent slots it is one-to-one
        rows = tree.rep[s - 1] > 0
        np.testing.assert_array_equal(C[rows].sum(0), tree.rep[s])


@requires_reference
def test_native_tree_fan_layout(native_lib, ref_problem):
    """C++ fan layout == pure-Python fan layout on the reference tree."""
    tree = ref_problem["tree"]
    nos, rep = tree._fan_layout_native()
    assert nos is not None
    # recompute in Python
    N, ns = tree.N, tree.ns
    py = np.zeros((N, ns), np.int32)
    for i, leaf in enumerate(tree.leaves):
        node = int(leaf)
        for s in range(N - 1, -1, -1):
            py[s, i] = node
            node = int(tree.ancestor[node])
    np.testing.assert_array_equal(nos, py)
    rep_py = np.zeros((N, ns), np.float32)
    rep_py[:, 0] = 1
    rep_py[:, 1:] = py[:, 1:] != py[:, :-1]
    np.testing.assert_array_equal(rep, rep_py)
