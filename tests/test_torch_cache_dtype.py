"""``Engine(cache_dtype=)`` and ``LM.init_paged_cache(dtype=)`` against the
JAX engine on the CPU: reduced ``llama3_2_1b`` in bf16 served over f32 KV
pools (the new k/v rounded to the model's dtype, then widened into the
pool, as JAX writes them), the greedy tokens equal on traffic that refills
slots mid-flight; and the pools' dtype."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.models import LM, from_jax_params
from repro_torch.serving import Engine


def _serve(engine_cls, model, params, traffic, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(p, m) for p, m in traffic]
    out = eng.drain(max_steps=500)
    return [out[r] for r in rids], eng


def test_engine_f32_pools_under_a_bf16_model_match_jax():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("llama3_2_1b")),
                               dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config("llama3_2_1b")),
                              dtype="bfloat16")
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(cfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    traffic = [(rng.integers(0, cfg.vocab_size, size=n).tolist(), m)
               for n, m in ((5, 6), (9, 4), (3, 7))]
    kw = dict(batch=2, max_len=32, page_size=8)
    jout, jeng = _serve(JaxEngine, jm, jp, traffic, cache_dtype=jnp.float32,
                        **kw)
    tout, teng = _serve(Engine, tm, tp, traffic, cache_dtype=torch.float32,
                        **kw)
    assert jeng.cache["stacks"][0]["kp"].dtype == jnp.float32
    assert teng.cache["stacks"][0]["kp"].dtype == torch.float32
    assert tout == jout
    # the default: pools in the model's dtype
    cache = tm.init_paged_cache(2, 5, 8, 4)
    assert cache["stacks"][0]["kp"].dtype == torch.bfloat16
    assert tm.init_paged_cache(2, 5, 8, 4, dtype=torch.float32)[
        "stacks"][0]["vp"].dtype == torch.float32
