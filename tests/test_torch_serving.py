"""Serving in the PyTorch port, on the CPU: the torch ``Engine`` emits the
JAX ``Engine``'s greedy tokens exactly on reduced ``llama3_2_1b`` (mixed
traffic, mid-flight refill, preemption, EOS), the copied page allocator and
scheduler keep their invariants, ``generate`` keeps its contracts, and the
package stays free of JAX."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks.serve import _traffic
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.models import LM, from_jax_params
from repro_torch.serving import Engine, PageAllocator, Scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    jm = JaxLM(jax_reduced(jax_get_config("llama3_2_1b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(reduced(get_config("llama3_2_1b")), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return tm, tp, jm, jp


def _serve(engine_cls, model, params, traffic, **kw):
    eng = engine_cls(model, params, **kw)
    rids = [eng.submit(p, m) for p, m in traffic]
    out = eng.drain(max_steps=500)
    return [out[r] for r in rids], eng


# ---------------------------------------------------------------------------
# engine parity with the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_engine_tokens_equal_jax_on_benchmark_traffic(pair, smoke):
    """Both ``benchmarks/serve.py::_traffic`` lists, at that benchmark's
    engine settings: more requests than slots, so slots refill mid-flight."""
    tm, tp, jm, jp = pair
    traffic = _traffic(np.random.RandomState(0), 4 if smoke else 8,
                       tm.cfg.vocab_size, smoke)
    kw = dict(batch=2, max_len=32, page_size=8) if smoke else \
        dict(batch=4, max_len=64, page_size=16)
    jout, _ = _serve(JaxEngine, jm, jp, traffic, **kw)
    tout, eng = _serve(Engine, tm, tp, traffic, **kw)
    assert tout == jout
    assert [len(t) for t in tout] == [m for _, m in traffic]
    eng.sched.pages.check_invariants()
    assert eng.sched.pages.free_pages == eng.sched.pages.num_pages - 1


def test_engine_preemption_tokens_equal_jax(pair):
    tm, tp, jm, jp = pair
    rng = np.random.default_rng(1)
    traffic = [(rng.integers(0, tm.cfg.vocab_size, size=n).tolist(), m)
               for n, m in ((6, 8), (10, 6), (4, 9))]
    kw = dict(batch=3, max_len=24, page_size=4, num_pages=9)
    jout, _ = _serve(JaxEngine, jm, jp, traffic, **kw)
    tout, eng = _serve(Engine, tm, tp, traffic, **kw)
    assert sum(r.preempted for r in eng._requests.values()) > 0
    assert tout == jout
    eng.sched.pages.check_invariants()


def test_engine_eos_retires_like_jax(pair):
    tm, tp, jm, jp = pair
    rng = np.random.default_rng(2)
    traffic = [(rng.integers(0, tm.cfg.vocab_size, size=n).tolist(), 8)
               for n in (5, 6, 4)]
    free, _ = _serve(Engine, tm, tp, traffic[:1], batch=2, max_len=32,
                     page_size=8)
    eos = free[0][2]
    kw = dict(batch=2, max_len=32, page_size=8, eos_id=eos)
    jout, _ = _serve(JaxEngine, jm, jp, traffic, **kw)
    tout, _ = _serve(Engine, tm, tp, traffic, **kw)
    assert tout == jout
    assert tout[0][-1] == eos and len(tout[0]) == 3


def test_engine_default_page_size(pair):
    tm, tp, _, _ = pair
    eng = Engine(tm, tp, batch=2, max_len=1056)
    assert eng.page_size == 352
    with pytest.raises(ValueError, match="pageable"):
        Engine(LM(dataclasses.replace(tm.cfg, window=8), device="cpu"), tp,
               batch=2, max_len=16)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def test_generate_pads_after_eos_and_raises_for_unpageable(pair):
    """EOS padding on the engine; a windowed model (unpageable) is served
    by the static path instead, and forcing the engine on it raises."""
    tm, tp, _, _ = pair
    prompts = np.random.RandomState(4).randint(
        0, tm.cfg.vocab_size, (2, 5)).astype(np.int32)
    base, stats = generate(tm, tp, prompts, gen_tokens=6)
    assert stats["engine"] and base.shape == (2, 6)
    eos = int(base[0, 2])
    out, _ = generate(tm, tp, prompts, gen_tokens=6, eos_id=eos, pad_id=0)
    stop = int(np.argmax(out[0] == eos))
    assert out[0, stop] == eos and (out[0, stop + 1:] == 0).all()
    windowed = LM(dataclasses.replace(tm.cfg, window=8), device="cpu")
    assert not windowed.pageable
    out, stats = generate(windowed, tp, prompts, gen_tokens=12)
    assert not stats["engine"] and out.shape == (2, 12)
    assert ((out >= 0) & (out < tm.cfg.vocab_size)).all()
    with pytest.raises(ValueError, match="pageable"):
        generate(windowed, tp, prompts, gen_tokens=2, engine="paged")


# ---------------------------------------------------------------------------
# copied allocator / scheduler invariants
# ---------------------------------------------------------------------------

def test_allocator_all_or_nothing_and_release():
    pa = PageAllocator(num_pages=6, page_size=4)
    a = pa.alloc("a", 3)
    assert a is not None and 0 not in a
    assert pa.alloc("b", 3) is None and pa.free_pages == 2
    pa.check_invariants()
    pa.release("a")
    assert pa.free_pages == 5
    pa.check_invariants()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_random_walk_never_leaks_pages(seed):
    rng = np.random.default_rng(seed)
    sched = Scheduler(batch=3, page_size=4, num_pages=10, max_len=24)
    for _ in range(300):
        op = int(rng.integers(0, 5))
        if op == 0 and len(sched.queue) < 6:
            sched.submit([1] * int(rng.integers(1, 12)),
                         int(rng.integers(1, 8)))
        elif op == 1:
            sched.admit()
        elif op == 2 and sched.running:
            slot = int(rng.choice(sched.running))
            req = sched.slots[slot]
            req.tokens.append(3)
            if len(req.tokens) >= req.max_new:
                sched.retire(slot)
            else:
                while not sched.grow(slot):
                    assert sched.preempt_youngest(exclude=slot) is not None
        elif op == 3 and sched.running:
            sched.preempt_youngest()
        elif op == 4 and sched.running:
            sched.retire(int(rng.choice(sched.running)))
        sched.pages.check_invariants()
    for slot in list(sched.running):
        sched.retire(slot)
    assert sched.pages.free_pages == 9


def test_admission_is_fifo_no_queue_jumping():
    sched = Scheduler(batch=2, page_size=4, num_pages=4, max_len=16)
    big = sched.submit([1] * 12, 4)          # needs 4 pages, only 3 free
    sched.submit([1], 1)
    assert sched.admit() == [] and sched.queue[0].rid == big


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    tools = os.path.join(ROOT, "tools")           # the port's A/B scripts
    files += [os.path.join(tools, n) for n in sorted(os.listdir(tools))
              if n.endswith(".py")]
    assert os.path.join(tools, "ab_norm_paged.py") in files
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert len(files) > 20


def test_cpu_step_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.models import LM\n"
        "from repro_torch.serving import Engine\n"
        "from repro_torch.launch.train import main\n"
        "m = LM(reduced(get_config('llama3_2_1b')), device='cpu')\n"
        "p = m.init(torch.Generator().manual_seed(0))\n"
        "e = Engine(m, p, batch=2, max_len=16, page_size=4)\n"
        "e.submit([1, 2, 3], 3)\n"
        "assert len(e.drain()[0]) == 3\n"
        "out = main(['--reduced', '--device', 'cpu', '--steps', '2', "
        "'--global-batch', '2', '--seq-len', '8'])\n"
        "assert len(out['history']) == 2\n"
        "for arch in ('musicgen_medium', 'falcon_mamba_7b'):\n"
        "    m = LM(reduced(get_config(arch)), device='cpu')\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    _, c = m.prefill(p, torch.ones((2, 5), dtype=torch.long), "
        "max_len=8)\n"
        "    nxt, _, c = m.greedy_step(p, torch.ones((2, 1), "
        "dtype=torch.long), c)\n"
        "    assert c['pos'] == 6 and nxt.shape == (2,)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-2000:]
