"""``Batches.epoch()`` on the CPU against gathering ``epoch_indices()``'s
arrays directly, batch by batch, over two consecutive epochs; and an epoch
abandoned after its first batch against the JAX ``Batches``' shuffle
stream."""

import numpy as np
import pytest
import torch

from geniconet_tpu.data.pipeline import Batches as JaxBatches
from geniconet_tpu_torch.data.datasets import synthetic_dataset
from geniconet_tpu_torch.data.pipeline import Batches

N, B = 11, 4


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(1, N, seed=0)


def _gathered(ds, idx, wt):
    return torch.from_numpy(ds.inputs[idx]), torch.from_numpy(ds.targets[idx]), torch.from_numpy(wt)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == torch.float32 and a.device.type == "cpu"
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw,sizes", [
    (dict(), [4, 4, 3]),  # shuffled, the ragged tail kept
    (dict(drop_remainder=True), [4, 4]),
    (dict(rank=0, world=2), [2, 2]),  # the training cut: the ragged tail dropped
    (dict(rank=1, world=2), [2, 2]),
    (dict(drop_remainder=False, rank=1, world=2), [2, 2, 1]),  # the ragged tail cut to 2 rows
    (dict(shuffle=False, rank=1, world=2), [2, 2, 2]),  # zero-weight padding
], ids=["ragged", "drop", "rank0", "rank1", "rank1-cut", "eval-pad"])
def test_epoch_gathers_the_epoch_indices(ds, kw, sizes):
    ours, ref = (Batches(ds, B, seed=7, device="cpu", **kw) for _ in range(2))
    for _ in range(2):
        got = list(ours.epoch())
        _assert_same(got, [_gathered(ds, idx, wt) for idx, wt in ref.epoch_indices()])
        assert [len(x) for x, _, _ in got] == sizes
    if not kw.get("shuffle", True):
        np.testing.assert_array_equal(got[-1][2].numpy(), [1, 0])


def test_an_abandoned_epoch_draws_one_shuffle(ds):
    """The benchmark's loader leaves an epoch at its deadline: the next
    epoch() draws the stream's next shuffle, as the JAX ``Batches``' second
    epoch does."""
    ours, ref = Batches(ds, B, seed=7, device="cpu"), JaxBatches(ds, B, shuffle=True, seed=7)
    first = ref.epoch_indices()
    it = ours.epoch()
    _assert_same([next(it)], [_gathered(ds, *next(first))])
    it.close()
    _assert_same(list(ours.epoch()), [_gathered(ds, idx, wt) for idx, wt in ref.epoch_indices()])
