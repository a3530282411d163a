"""Registry-wide kernel lint: the analyzer over every op (the counterpart
of ``repro.lint_kernels``).

Every registered op is analyzed at its example shapes across its derived
defines and every combination of its tuning sweep (the candidates
``op.tune`` builds): grid invariants, dimension semantics, the
shared-memory footprint and the body pass (scratch liveness, output
coverage; ``repro_torch.core.analyze``). The builders a family builds
beside its op's (flash attention's delta and backward, the LM head's CE
backward, the ring step's backward) are linted at the same defines.

  PYTHONPATH=src python -m repro_torch.lint_kernels            # the table
  PYTHONPATH=src python -m repro_torch.lint_kernels --strict   # any finding fails
  PYTHONPATH=src python -m repro_torch.lint_kernels --json PATH
  PYTHONPATH=src python -m repro_torch.lint_kernels --cost     # + the cost table

``--cost`` also runs the cost model (footprint against the H100's
shared memory a block, ``$REPRO_SMEM_BUDGET`` to override; device-memory
bytes; FLOPs; intensity) on every op's derived defines, its findings
(``SMEM_OVERFLOW``, ``FOOTPRINT_NEAR_LIMIT``, ``REDUNDANT_FETCH``) joining
the verdict, and previews which sweep candidates the cost model prunes on
the torch and loops backends. ``--cost-json PATH`` writes that table.
Builds nothing for a device, and runs on the CPU as on the card.

Exit status: 0 when clean; 1 on any error finding (on any finding at all
under ``--strict``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["aux_builders", "cost_op", "lint_op", "main"]


def aux_builders(op_name: str) -> list:
    """The builders a family builds beside its op's (no registry entry of
    their own), linted with the op's defines, a superset of theirs."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.lm_head import kernel as lk

    return {
        "flash_attention": [("flash_attention/delta", fk.flash_delta_builder),
                            ("flash_attention/bwd", fk.flash_bwd_builder)],
        "lm_head_ce": [("lm_head_ce/bwd", lk.lm_head_bwd_builder)],
        "ring_flash": [("ring_flash/delta", fk.flash_delta_builder),
                       ("ring_flash/bwd", fk.ring_flash_bwd_builder)],
    }.get(op_name, [])


def _example_defines(op, rng):
    from repro_torch.core import to_tensors

    args, params = to_tensors(*op.example(rng), "cpu")
    _, params = op._resolve(params)
    return op.derive_defines(args, params)


def _candidates(op, defines: dict):
    """The derived defines first, then every sweep combination over them:
    the candidates a tuning run builds."""
    from repro_torch.core.tune import candidates

    yield dict(defines)
    yield from candidates(defines, op.sweep)


def _finding_dict(f) -> dict:
    return dict(code=f.code, spec=f.spec, subject=f.subject,
                severity=f.severity, message=f.message)


def lint_op(op, rng=None) -> dict:
    """Analyze one op across its example-shaped candidates. Returns
    ``{"checked", "skipped", "findings"}`` (unique finding dicts); a
    candidate whose tiles do not fit the shapes (one ``op.tune`` skips)
    counts as skipped, not as a finding."""
    from repro_torch.core.analyze import AnalysisError, analyze_spec
    from repro_torch.core.lang import defines_namespace

    defines = _example_defines(op, rng or np.random.RandomState(0))
    builders = [(op.name, op.builder)] + aux_builders(op.name)
    checked = skipped = 0
    findings: dict[tuple, dict] = {}

    def add(fs):
        for f in fs:
            findings[(f.code, f.spec, f.subject, f.message)] = \
                _finding_dict(f)

    for cand in _candidates(op, defines):
        D = defines_namespace(cand)
        for _label, builder in builders:
            try:
                spec = builder(D)
            except AnalysisError as e:
                add(e.findings)
                continue
            except (ValueError, AssertionError):
                skipped += 1   # tiles that do not fit: tune skips them
                continue
            add(analyze_spec(spec, D).findings)
            checked += 1
    return {"checked": checked, "skipped": skipped,
            "findings": list(findings.values())}


def _cost_dict(rep) -> dict:
    return dict(
        spec=rep.spec, grid=list(rep.grid), cells=rep.cells,
        smem_bytes=rep.smem_bytes, smem_budget=rep.smem_budget,
        smem_frac=round(rep.smem_frac, 4), bytes_in=rep.bytes_in,
        bytes_out=rep.bytes_out, hbm_bytes=rep.hbm_bytes, flops=rep.flops,
        intensity=(None if rep.intensity is None
                   else round(rep.intensity, 4)),
        comm_bytes=rep.comm_bytes, comm_detail=dict(rep.comm_detail),
        findings=[_finding_dict(f) for f in rep.findings])


def cost_op(op, rng=None) -> dict:
    """The cost model at one op's derived defines: a footprint, bytes and
    FLOPs report for each builder of its family, and which sweep
    candidates the cost model prunes (the torch and loops rule)."""
    from repro_torch.core import estimate_cost
    from repro_torch.core.lang import defines_namespace
    from repro_torch.core.tune import prune_by_cost

    defines = _example_defines(op, rng or np.random.RandomState(0))
    D = defines_namespace(defines)
    kernels = []
    for label, builder in [(op.name, op.builder)] + aux_builders(op.name):
        try:
            spec = builder(D)
        except (ValueError, AssertionError):
            continue
        kernels.append(dict(_cost_dict(estimate_cost(spec, D)),
                            kernel=label))
    kept, pruned = prune_by_cost(op.builder, defines, dict(op.sweep))
    return {"kernels": kernels, "sweep_kept": len(kept),
            "sweep_pruned": [
                {"overrides": {k: c[k] for k in sorted(op.sweep)},
                 "reason": r} for c, r in pruned]}


def _write_json(path, payload):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
    print(f"[lint] wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint_kernels", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--op", default=None,
                    help="lint ONE op (default: the whole registry)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any finding, coverage warnings included")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the findings to PATH")
    ap.add_argument("--cost", action="store_true",
                    help="also run the cost model: footprint, bytes and "
                         "FLOPs a kernel, and the sweep prune preview; its "
                         "findings join the verdict")
    ap.add_argument("--cost-json", default=None, metavar="PATH",
                    help="write the cost table to PATH (implies --cost)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cost_json:
        args.cost = True

    from repro_torch.core import registered_ops

    ops = registered_ops()
    if args.op is not None:
        if args.op not in ops:
            ap.error(f"unknown op {args.op!r}; known: {sorted(ops)}")
        ops = {args.op: ops[args.op]}

    results, costs = {}, {}
    for name in sorted(ops):
        results[name] = lint_op(ops[name], np.random.RandomState(args.seed))
        if args.cost:
            costs[name] = cost_op(ops[name], np.random.RandomState(args.seed))
            seen = {(f["code"], f["spec"], f["subject"], f["message"])
                    for f in results[name]["findings"]}
            for k in costs[name]["kernels"]:
                for f in k["findings"]:
                    key = (f["code"], f["spec"], f["subject"], f["message"])
                    if key not in seen:
                        seen.add(key)
                        results[name]["findings"].append(f)

    n_err = sum(1 for r in results.values() for f in r["findings"]
                if f["severity"] == "error")
    n_all = sum(len(r["findings"]) for r in results.values())
    ok = (n_all == 0) if args.strict else (n_err == 0)

    w = max(len(n) for n in results) if results else 2
    print(f"{'op':<{w}}  {'checked':>7}  {'skipped':>7}  {'findings':>8}  "
          "verdict")
    for name, r in results.items():
        nf = len(r["findings"])
        bad = any(f["severity"] == "error" for f in r["findings"]) or (
            args.strict and nf)
        verdict = "FAIL" if bad else ("WARN" if nf else "OK")
        print(f"{name:<{w}}  {r['checked']:>7}  {r['skipped']:>7}  "
              f"{nf:>8}  {verdict}")
    for name, r in results.items():
        for f in r["findings"]:
            print(f"  {name}: [{f['code']}] {f['message']}")

    if args.cost:
        print()
        kw = max((len(k["kernel"]) for c in costs.values()
                  for k in c["kernels"]), default=6)
        print(f"{'kernel':<{kw}}  {'smem B':>10}  {'%bud':>5}  "
              f"{'hbm B':>12}  {'flops':>14}  {'flop/B':>7}  "
              f"{'comm B':>10}  pruned")
        for name, c in costs.items():
            for i, k in enumerate(c["kernels"]):
                fl = "?" if k["flops"] is None else f"{k['flops']:,}"
                ai = "?" if k["intensity"] is None else \
                    f"{k['intensity']:.2f}"
                cm = "-" if not k["comm_bytes"] else f"{k['comm_bytes']:,}"
                npruned = (f"{len(c['sweep_pruned'])}/"
                           f"{len(c['sweep_pruned']) + c['sweep_kept']}"
                           if i == 0 else "")
                print(f"{k['kernel']:<{kw}}  {k['smem_bytes']:>10,}  "
                      f"{k['smem_frac']:>5.0%}  {k['hbm_bytes']:>12,}  "
                      f"{fl:>14}  {ai:>7}  {cm:>10}  {npruned}")
        for name, c in costs.items():
            for p in c["sweep_pruned"]:
                print(f"  {name}: {p['overrides']} -> {p['reason']}")

    if args.cost_json:
        _write_json(args.cost_json, {"schema": 1, "ops": costs})
    if args.json:
        payload = {"schema": 1, "strict": bool(args.strict), "ok": ok,
                   "ops": results}
        if args.cost:
            payload["cost"] = costs
        _write_json(args.json, payload)

    print(f"[lint] {len(results)} ops, {n_all} findings ({n_err} errors)"
          f"{' (strict)' if args.strict else ''}: {'ok' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
