"""The store and graph states are frozen dataclasses registered as JAX
pytrees (utils/pytree): they pass through jit, flatten and unflatten to
equal values, and `.replace` returns an updated copy.  An Optional field
left at None is an empty subtree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.core.store import Int8StoreState, init_store
from vector_db_tpu.ops import hnsw_graph as hg


def _states():
    return {
        "store": init_store(256, 16),
        "int8_store": init_store(256, 16, raw=False),
        "int8_store_residual": init_store(256, 16, raw=False, residual=True),
        "graph": hg.init_graph(256, 8, 3),
    }


@pytest.mark.parametrize("name", sorted(_states()))
def test_state_is_a_pytree(name):
    state = _states()[name]
    leaves, treedef = jax.tree_util.tree_flatten(state)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(again) is type(state)
    for a, b in zip(jax.tree_util.tree_leaves(again), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # through jit: the same structure comes back, every leaf transformed
    bumped = jax.jit(lambda s: jax.tree_util.tree_map(lambda x: x + 1, s))(
        state)
    assert jax.tree_util.tree_structure(bumped) == treedef
    for a, b in zip(jax.tree_util.tree_leaves(bumped), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b) + 1)

    # .replace: an updated copy; the frozen original is unchanged
    first = dataclasses.fields(state)[0].name
    new = state.replace(**{first: getattr(state, first) + 2})
    np.testing.assert_array_equal(np.asarray(getattr(new, first)),
                                  np.asarray(getattr(state, first)) + 2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(state, first, None)


def test_optional_fields_stay_empty_subtrees():
    plain = init_store(256, 16, raw=False)
    resid = init_store(256, 16, raw=False, residual=True)
    assert isinstance(plain, Int8StoreState)
    assert plain.resid is None and plain.rscales is None
    n_plain = len(jax.tree_util.tree_leaves(plain))
    assert len(jax.tree_util.tree_leaves(resid)) == n_plain + 2
    out = jax.jit(lambda s: s.replace(valid=jnp.ones_like(s.valid)))(plain)
    assert out.resid is None and bool(out.valid.all())
