"""The port's copies of ModelConfig and the arch registry equal the JAX
package's, field by field."""
import dataclasses

import jax  # noqa: F401  (both packages in one process, as in every test_torch_* file)
import numpy as np  # noqa: F401
import pytest
import torch  # noqa: F401

from repro import configs as jconfigs
from repro.models import config as jconfig

from repro_torch import configs as pconfigs
from repro_torch.models import config as pconfig

ARCHS = jconfigs.list_archs()


def test_same_registry():
    assert pconfigs.list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal_field_by_field(arch):
    j, p = jconfigs.get_config(arch), pconfigs.get_config(arch)
    assert type(p) is pconfig.ModelConfig
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(j.reduced())
    for prop in ("kv_heads", "hd", "is_attention_free", "supports_decode",
                 "supports_long_context"):
        assert getattr(p, prop) == getattr(j, prop), prop
    assert p.pattern_for_layers() == j.pattern_for_layers()


def test_dataclass_fields_and_defaults_equal():
    for jc, pc in ((jconfig.ModelConfig, pconfig.ModelConfig),
                   (jconfig.MoEConfig, pconfig.MoEConfig)):
        jf, pf = dataclasses.fields(jc), dataclasses.fields(pc)
        assert [(f.name, f.type, f.default) for f in pf] == \
               [(f.name, f.type, f.default) for f in jf]


def test_lookup_by_underscore_name_and_unknown_arch():
    assert pconfigs.get_config("smollm_135m") is pconfigs.get_config("smollm-135m")
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get_config("nope")


def test_validate_rejects_the_same_configs():
    bad = dict(arch_id="x", family="dense", n_layers=1, d_model=64, n_heads=3,
               n_kv_heads=2, d_ff=64, vocab_size=8)
    for mod in (jconfig, pconfig):
        with pytest.raises(ValueError, match="not divisible"):
            mod.ModelConfig(**bad).validate()
