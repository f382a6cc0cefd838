"""The port's ModelConfig parameter counts against the JAX package's.

Every family preset (Mixtral's experts and router included) gives the
same total and active counts in both packages, and the port's FLOP count
per token bills the active params, as the JAX package's does.
"""

import pytest

from gke_ray_train_tpu.models import config as jcfg
from gke_ray_train_tpu.train import metrics as jmetrics
from gke_ray_train_tpu_torch.models import config as tcfg
from gke_ray_train_tpu_torch.train import metrics as tmetrics

PRESETS = ("llama2_7b", "llama2_13b", "llama2_70b", "llama3_8b",
           "llama3_70b", "mistral_7b", "mixtral_8x7b", "qwen2_7b",
           "gemma2_9b")


@pytest.mark.parametrize("name", PRESETS)
def test_param_counts_match_jax(name):
    t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_mixtral_counts_every_expert_and_the_router():
    cfg = tcfg.mixtral_8x7b()
    assert cfg.param_count() == 46_702_792_704
    assert cfg.active_param_count() == jcfg.mixtral_8x7b().active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    dense = tcfg.llama3_8b()
    assert dense.active_param_count() == dense.param_count()


@pytest.mark.parametrize("name", ("mixtral_8x7b", "llama3_8b", "gemma2_9b"))
@pytest.mark.parametrize("trainable", ("full", "lora"))
def test_train_flops_per_token_match_jax(name, trainable):
    t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert tmetrics.train_flops_per_token(t, 1024, trainable=trainable) \
        == jmetrics.train_flops_per_token(j, 1024, trainable=trainable)
