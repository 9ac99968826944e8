"""The port's copy of the data pipeline against the JAX package's.

``repro_torch.data.pipeline`` is numpy only: every batch must be byte for
byte ``repro.data.pipeline``'s, for each seed, shard and step.
"""
import dataclasses

import numpy as np
import pytest

import repro.data.pipeline as jdata
from repro.configs import get_config as jax_get_config

import repro_torch.data.pipeline as pdata
from repro_torch.configs import get_config


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("num_shards,shard_index", [(1, 0), (2, 1), (4, 3)])
def test_batch_at_is_byte_equal(seed, num_shards, shard_index):
    kw = dict(global_batch=8, seq_len=33, vocab_size=512, seed=seed, noise=0.2,
              num_shards=num_shards, shard_index=shard_index)
    ref, port = jdata.SyntheticLMDataset(jdata.DataConfig(**kw)), \
        pdata.SyntheticLMDataset(pdata.DataConfig(**kw))
    assert np.array_equal(ref.perm, port.perm)
    for step in (0, 1, 5, 1000):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (k, step)


def test_iterator_matches_batch_at():
    cfg = pdata.DataConfig(global_batch=2, seq_len=8, vocab_size=64, seed=3)
    it, ds = pdata.make_batch_iterator(cfg), pdata.SyntheticLMDataset(cfg)
    jt = jdata.make_batch_iterator(jdata.DataConfig(**dataclasses.asdict(cfg)))
    for step in range(3):
        a, b, c = next(it), ds.batch_at(step), next(jt)
        assert all(a[k].tobytes() == b[k].tobytes() == c[k].tobytes() for k in a)


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="divide evenly"):
        pdata.SyntheticLMDataset(pdata.DataConfig(global_batch=5, seq_len=4, vocab_size=16,
                                                  num_shards=2))


@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge", "paligemma-3b"])
def test_synthetic_batch_is_byte_equal(arch):
    a = jdata.synthetic_batch(jax_get_config(arch).reduced(), 2, 12, seed=4)
    b = pdata.synthetic_batch(get_config(arch).reduced(), 2, 12, seed=4)
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
