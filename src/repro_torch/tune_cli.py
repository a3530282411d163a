"""``op.tune`` from the command line: pre-tune the port's kernels for a
card (the counterpart of ``repro.tune_cli``).

Sweeps registered ops' knobs on real shapes and keeps the winners under
``$REPRO_CACHE_DIR`` (default ``~/.cache/repro-occa``, entries in
``autotune_torch/``). Later runs on the same card, torch, CUDA and kernel
sources adopt them at warmup for free (``launch.tuning.adopt``, the app
drivers' ``block=None``/``eb=None``): a lookup, nothing built or timed.
Runs on the CUDA card unless ``--device cpu`` is given (which times the
specs' torch expansions, keyed apart from the card's).

  # the ops a serving + training deployment of an arch meets; the decode
  # probes at full caches, the paged one at the live lengths measured on
  # the traffic if given (one engine step's, one per slot)
  PYTHONPATH=src python -m repro_torch.tune_cli --arch llama3_2_1b \\
      --batch 8 --max-len 2048 [--serve | --train] [--reduced] \\
      [--paged-lens 1000,412,...]

  # one op on its example shapes
  PYTHONPATH=src python -m repro_torch.tune_cli --op fd2d

  # the paper's apps (fd2d, sem_apply, dg_volume, dg_surface) at the
  # drivers' shapes (default: python -m repro_torch.launch.apps's)
  PYTHONPATH=src python -m repro_torch.tune_cli --apps \\
      [--fd-size 256 --fd-radius 2 --sem-elems 3 --sem-n 4 --dg-nx 8 --dg-n 3]

  # what is tunable; audit the persisted winners (ops gone from the
  # registry, winners the wrappers now refuse or whose specs the analyzer
  # flags); --evict drops them
  PYTHONPATH=src python -m repro_torch.tune_cli --list
  PYTHONPATH=src python -m repro_torch.tune_cli --lint [--evict]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import registered_ops, to_tensors, tune_cache_dir
from repro_torch.core.tune import CACHE_SUBDIR, SCHEMA_VERSION, prune_candidates

__all__ = ["main", "run"]


def _knobs(op, result) -> dict:
    return {k: result[k] for k in sorted(op.sweep)}


def _tune_probe(op, args, params, *, repeats, cache, results):
    """Tune one probe; prints each candidate's time and the winner line."""
    def log(knobs, sec):
        print(f"[tune]   {op.name} {knobs}: {sec * 1e3:.4f} ms")

    r = op.tune(tuple(args), repeats=repeats, cache=cache, log=log, **params)
    if r.cached:
        state = "cache hit"
    else:
        state = (f"{len(r.trials)} trials, {len(r.pruned)} pruned, "
                 f"{len(r.skipped) - len(r.pruned)} skipped")
        for cand, reason in r.skipped:
            print(f"[tune]   skipped {({k: cand[k] for k in op.sweep})}: "
                  f"{reason}")
    print(f"[tune] {op.name}: winner {_knobs(op, r)} "
          f"({state}, best {r.best_seconds * 1e6:.1f} us; {r.seconds:.2f} s)")
    results.append((op.name, r))
    return r


def _randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _materialize(args, params, *, vocab, gen, device):
    """A probe's meta tensors as real ones on ``device`` (int32 ones as
    token ids below ``vocab``); real tensors are moved there."""
    def real(t):
        if not torch.is_tensor(t):
            return t
        if t.device.type != "meta":
            return t.to(device)
        if t.dtype == torch.int32:
            return torch.randint(0, max(int(vocab), 1), tuple(t.shape),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
        return _randn(tuple(t.shape), t.dtype, gen, device)

    return tuple(real(a) for a in args), {k: real(v)
                                          for k, v in params.items()}


def _water(E, n, gen, device):
    """(E, n, 3) shallow-water states: h near 2, small momenta."""
    q = 0.3 * torch.randn((E, n, 3), generator=gen, device=device)
    q[..., 0] = 2.0 + 0.1 * q[..., 0]
    return q


def _app_probes(a, gen, device):
    """(op name, real args, params) for the apps at their drivers' shapes:
    the probe shapes are the drivers' own (``fd_probe``, ``sem_probe``,
    ``volume_probe``, ``surface_probe``), so the keys are those the drivers
    look up; the values are random (a winner depends on shapes alone)."""
    from repro_torch.apps.dg_swe import surface_probe, volume_probe
    from repro_torch.apps.fd2d import fd_probe
    from repro_torch.apps.sem import sem_probe

    (u, _), params = fd_probe(a.fd_size, a.fd_size, a.fd_radius)
    yield ("fd2d", (_randn(u.shape, u.dtype, gen, device),
                    _randn(u.shape, u.dtype, gen, device)), params)
    nq = a.sem_n + 1
    for e in a.sem_elems:
        metas, params = sem_probe(e ** 3, nq)
        yield ("sem_apply", tuple(_randn(t.shape, t.dtype, gen, device)
                                  for t in metas), params)
    np_, nfp3, E = (a.dg_n + 1) * (a.dg_n + 2) // 2, 3 * (a.dg_n + 1), \
        2 * a.dg_nx ** 2
    metas, params = volume_probe(E, np_)
    yield ("dg_volume", (_water(E, np_, gen, device),) + tuple(
        _randn(t.shape, t.dtype, gen, device) for t in metas[1:]), params)
    metas, params = surface_probe(E, np_, nfp3)
    theta = torch.rand((E, nfp3), generator=gen, device=device) * 6.2832
    nrm = torch.stack([torch.cos(theta), torch.sin(theta), 1.0 + torch.rand(
        (E, nfp3), generator=gen, device=device)], -1)
    yield ("dg_surface", (_water(E, nfp3, gen, device),
                          _water(E, nfp3, gen, device), nrm,
                          _randn(metas[3].shape, torch.float32, gen, device)),
           params)


def _lint_cache(ops, *, evict: bool) -> int:
    """Audit every persisted winner: flag entries that are corrupt, of
    another schema, whose op left the registry, whose winner the op's
    wrapper now refuses at the entry's shapes, or whose spec the analyzer
    now flags (JAX's ``_lint_cache``: a winner tuned under another
    ``$REPRO_SMEM_BUDGET`` cannot come back with oversized tiles; a card
    winner's footprint is the kernel's own, which its refusal checks).
    ``evict`` deletes them. Returns an exit code (1 when flagged entries
    stay on disk)."""
    from repro_torch.core import analyze_spec, defines_namespace

    root = tune_cache_dir() / CACHE_SUBDIR
    entries = sorted(root.glob("*.json")) if root.is_dir() else []
    bad = 0
    for path in entries:
        try:
            entry = json.loads(path.read_text())
            problem = None if isinstance(entry, dict) else "not an object"
        except (OSError, ValueError):
            entry, problem = {}, "corrupt JSON"
        entry = entry if isinstance(entry, dict) else {}
        name = entry.get("op", "?")
        op = ops.get(name)
        winner = entry.get("winner")
        if problem is None and entry.get("schema") != SCHEMA_VERSION:
            problem = f"schema {entry.get('schema')} != {SCHEMA_VERSION}"
        if problem is None and op is None:
            problem = "op no longer registered"
        if problem is None and (not isinstance(winner, dict) or not all(
                k in winner for k in entry.get("sweep", {}))):
            problem = "winner lacks a swept knob"
        cand = dict(entry.get("defines", {}), **(winner or {}))
        if problem is None and op.refusal is not None:
            problem = op.refusal(cand)
            if problem is not None:
                problem = f"the wrapper refuses the winner: {problem}"
        if problem is None:
            try:
                D = defines_namespace(cand)
                found = analyze_spec(
                    op.builder(D), D,
                    footprint=entry.get("backend") != "cuda").findings
            except ValueError as e:        # the defines no longer build
                found = [e]
            if found:
                problem = ("the analyzer flags the winner: "
                           + "; ".join(str(f) for f in found))
        if problem is None:
            continue
        bad += 1
        print(f"[lint] {'evicting' if evict else 'stale'} {path.name} "
              f"(op {name!r}): {problem}")
        if evict:
            try:
                path.unlink()
            except OSError:
                pass
    print(f"[lint] {len(entries)} cached winners, {bad} stale"
          f"{' (evicted)' if evict and bad else ''}"
          f"{'; re-run with --evict to drop them' if bad and not evict else ''}")
    return 0 if (bad == 0 or evict) else 1


def _list(ops):
    for name in sorted(ops):
        op = ops[name]
        sweep = {k: op.sweep[k] for k in sorted(op.sweep)}
        print(f"{name}: sweep={sweep or '(none: template tiles)'}")
        if not op.sweep or op.example is None:
            continue
        args, params = to_tensors(*op.example(np.random.RandomState(0)),
                                  "cpu")
        defines = op.derive_defines(args, dict(op.defaults, **params))
        kept, pruned = prune_candidates(defines, op.sweep, op.smem)
        print(f"  example shapes {defines}: {len(pruned)}/"
              f"{len(kept) + len(pruned)} candidates pruned by shared memory")


def run(argv=None):
    """The CLI: returns (exit code, [(op name, TuneResult)])."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune_cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--list", action="store_true",
                    help="list registered ops and their sweeps")
    ap.add_argument("--lint", action="store_true",
                    help="audit persisted winners against the registry, "
                         "the wrappers' limits and the analyzer")
    ap.add_argument("--evict", action="store_true",
                    help="with --lint: delete the flagged entries")
    ap.add_argument("--op", default=None,
                    help="tune ONE op on its example shapes")
    ap.add_argument("--apps", action="store_true",
                    help="tune fd2d, sem_apply, dg_volume and dg_surface at "
                         "the apps' shapes")
    ap.add_argument("--fd-size", type=int, default=256)
    ap.add_argument("--fd-radius", type=int, default=2)
    ap.add_argument("--sem-elems", type=int, nargs="+", default=[3],
                    help="SEM meshes of e^3 elements (one probe each)")
    ap.add_argument("--sem-n", type=int, default=4)
    ap.add_argument("--dg-nx", type=int, default=8)
    ap.add_argument("--dg-n", type=int, default=3)
    ap.add_argument("--arch", default=None,
                    help="tune every op a serving and training deployment "
                         "of this arch meets (launch.tuning probes)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--paged-lens", default=None,
                    help="with --arch: the paged decode probe's live "
                         "lengths, one per slot, comma-separated (0 an idle "
                         "slot; default every cache full)")
    ap.add_argument("--serve", action="store_true",
                    help="with --arch: the serving probes only")
    ap.add_argument("--train", action="store_true",
                    help="with --arch: the train-step probes only")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (times the torch "
                         "expansions)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-cache", action="store_true",
                    help="sweep without persisting winners (a dry run)")
    args = ap.parse_args(argv)

    ops = registered_ops()
    results = []
    if args.lint:
        return _lint_cache(ops, evict=args.evict), results
    if args.evict:
        ap.error("--evict only makes sense with --lint")
    if args.list:
        _list(ops)
        return 0, results

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(repeats=args.repeats, cache=not args.no_cache, results=results)
    if args.apps:
        print(f"[tune] apps on {device}")
        for name, real, params in _app_probes(args, gen, device):
            _tune_probe(ops[name], real, params, **kw)
    elif args.op is not None:
        op = ops.get(args.op)
        if op is None:
            ap.error(f"unknown op {args.op!r}; known: {sorted(ops)}")
        if not op.sweep:
            ap.error(f"op {args.op!r} declares no tuning sweep")
        real, params = to_tensors(*op.example(np.random.RandomState(0)),
                                  device)
        _tune_probe(op, real, params, **kw)
    else:
        if args.arch is None:
            ap.error("pass --list, --lint, --op NAME, --apps or --arch NAME")
        from repro_torch.configs import get_config, reduced as reduce_cfg
        from repro_torch.launch.tuning import serving_probes, train_probes

        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
        max_len = args.max_len or (args.prompt_len + 32)
        probes = {}
        both = not (args.serve ^ args.train)
        if args.serve or both:
            lens = (None if args.paged_lens is None else
                    [int(x) for x in args.paged_lens.split(",")])
            probes.update(serving_probes(cfg, args.batch, args.prompt_len,
                                         max_len, paged_lens=lens))
        if args.train or both:
            probes.update(train_probes(cfg, args.batch, args.seq_len))
        print(f"[tune] arch={args.arch} on {device}: probes "
              f"{sorted(probes)}")
        for name in sorted(probes):
            op = ops.get(name)
            if op is None or not op.sweep:
                continue
            metas, params = probes[name]
            try:
                op.derive_defines(metas, dict(op.defaults, **params))
            except ValueError as e:       # outside the kernel's domain
                print(f"[tune] {name}: skipped ({e})")
                continue
            real, params = _materialize(metas, params, vocab=cfg.vocab_size,
                                        gen=gen, device=device)
            _tune_probe(op, real, params, **kw)
    if not args.no_cache:
        print(f"[tune] winners persisted under {tune_cache_dir()} "
              f"({CACHE_SUBDIR}/): warmup adopts them")
    return 0, results


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    raise SystemExit(main())
