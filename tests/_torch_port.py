"""Shared inputs of the port's JAX-comparison tests (tests/test_torch_*.py):
a reduced arch (llama3.2-3b unless asked) under a policy, the JAX
package's weights for it, and seeded prompts. Weights come from the JAX package's own init and are
carried to the port through numpy by `repro_torch.bridge`."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config

CACHE_LEN = 32
PAGE_SIZE = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module that imports this runs: its
    tensors are small, and the CPU is shared with the other test workers'
    JAX compiles, against which a pool of spinning torch threads only waits
    (measured: the reduced MoE servers 5-10x slower with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def built(policy: str, n_layers: int = 2, arch: str = "llama3.2-3b"):
    """(jax cfg, port cfg, JAX train params, JAX packed params)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               policy=policy, n_layers=n_layers)
    tcfg = dataclasses.replace(get_config(arch).reduced(),
                               policy=policy, n_layers=n_layers)
    params = jtransformer.init(jax.random.PRNGKey(0), jcfg)
    sparams = jtransformer.pack_for_serve(params, jcfg)
    return jcfg, tcfg, params, sparams


@functools.lru_cache(maxsize=None)
def built_twins(policy: str, n_layers: int = 2, arch: str = "llama3.2-3b"):
    """`built`, its JAX packed params with the stacked bit-plane twin
    (`pack_for_serve(..., plane_twins=True)`) that `--impl planes` and the
    speculative draft read."""
    jcfg, tcfg, params, _ = built(policy, n_layers, arch)
    return jcfg, tcfg, params, jtransformer.pack_for_serve(params, jcfg,
                                                          plane_twins=True)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def prompts(cfg, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
