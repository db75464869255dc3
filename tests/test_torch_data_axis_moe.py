"""The production layout's train step with its data axes over ranks on
moonshot tiny (the MoE capacity dispatch), against the JAX package, on
the meshes (2, 2) and (4, 1) over ("data", "model"): the checks of
``tests/test_torch_data_axis.py`` (its own group of four gloo ranks and
the reference's jitted ``build_train_step`` on a ``jax.sharding.Mesh``
of the same shape), and every dispatch's slots and drops.

The capacity takes C from each data shard's rows (the reference's
``_capacity`` of B / data x S tokens), so the step depends on the data
size and the one-device step is not its oracle: the reference's on the
same mesh shape is.  A file of its own so that ``--dist loadfile`` runs
it beside the granite cases."""
import pytest

import _torch_data_axis as W
import test_torch_data_axis as D

MOONSHOT = [k for k in W.TRAIN_CASES if k.startswith("moonshot")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank results]) of the moonshot cases."""
    return D.run_cases(tmp_path_factory, MOONSHOT)


@pytest.mark.parametrize("key", MOONSHOT)
def test_train_step_matches_reference(runs, key):
    D.check_train_step(runs, key)


@pytest.mark.parametrize("key", MOONSHOT)
def test_train_metrics_match_reference(runs, key):
    D.check_train_metrics(runs, key)


@pytest.mark.parametrize("key", MOONSHOT)
def test_batch_rows_over_the_data_axes(runs, key):
    D.check_batch_rows(runs, key)


@pytest.mark.parametrize("key", MOONSHOT)
def test_collectives_by_axis(runs, key):
    D.check_collectives(runs, key)


@pytest.mark.parametrize("key", MOONSHOT)
def test_dispatch_slots_and_drops_exact(runs, key):
    D.check_dispatch(runs, key)
