"""Per-rule lint findings table and the baseline ratchet, over the port.

``python -m llama_fastapi_k8s_gpu_tpu_torch.tools.lint_report`` prints one
row per rule (findings, suppressed count, description), then any
unsuppressed findings in full.  The CI entry points are ``python -m
llama_fastapi_k8s_gpu_tpu_torch.lint`` (exit code) and ``ci_gate``; this is
the overview for working on the tree.

Baseline mode (the rule-tightening ratchet): a stricter rule can land
against a tree with known findings by snapshotting them first.  NEW
findings fail, grandfathered ones are listed and tolerated until fixed, and
fixed ones are reported so the baseline can shrink::

  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.lint_report \\
      --write-baseline lint_baseline_torch_concurrency.json \\
      --rules LOCK005 LOCK006 ASY001 ASY002
  python -m llama_fastapi_k8s_gpu_tpu_torch.tools.lint_report \\
      --baseline lint_baseline_torch_concurrency.json \\
      --rules LOCK005 LOCK006 ASY001 ASY002

Baseline entries are keyed (rule, path, message) WITHOUT line numbers, so
unrelated edits that shift a grandfathered finding do not break the
ratchet; duplicate keys are counted (N occurrences grandfather N).  The
file format is the JAX package's (tools/lint_report.py), schema 1.

Options mirror the lint's CLI where useful:
  --all       also list suppressed findings (with their reasons)
  --rule R    restrict to one rule ID; --rules R [R ...] to a family
  --package/--root   analyze another tree (fixture self-tests)

Stdlib only, no torch.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

from ..lint import all_rules, run_lint

BASELINE_SCHEMA = 1


def _key(f) -> tuple[str, str, str]:
    return (f.rule, f.path, f.message)


def write_baseline(path: str, findings) -> int:
    live = [f for f in findings if not f.suppressed]
    doc = {
        "schema": BASELINE_SCHEMA,
        "findings": [{"rule": r, "path": p, "message": m}
                     for r, p, m in sorted(_key(f) for f in live)],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"baseline written: {len(live)} finding(s) -> {path}")
    return 0


def compare_baseline(path: str, findings) -> int:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != BASELINE_SCHEMA:
        print(f"unsupported baseline schema: {doc.get('schema')!r}")
        return 2
    grandfathered = collections.Counter(
        (e["rule"], e["path"], e["message"]) for e in doc["findings"])
    live = [f for f in findings if not f.suppressed]
    seen: collections.Counter = collections.Counter()
    new = []
    for f in sorted(live, key=lambda f: (f.path, f.line, f.rule)):
        k = _key(f)
        seen[k] += 1
        if seen[k] > grandfathered.get(k, 0):
            new.append(f)
    old_count = sum(min(seen.get(k, 0), n)
                    for k, n in grandfathered.items())
    fixed = [k for k, n in grandfathered.items() if seen.get(k, 0) < n]
    if new:
        print("NEW findings (not in baseline — fix these):")
        for f in new:
            print("  " + f.render())
    if old_count:
        print(f"{old_count} grandfathered finding(s) tolerated "
              f"(baseline: {path})")
    if fixed:
        print(f"{len(fixed)} baseline entr{'y is' if len(fixed) == 1 else 'ies are'} "
              "no longer found — shrink the baseline:")
        for rule, bpath, msg in sorted(fixed):
            print(f"  {rule} {bpath}: {msg[:80]}")
    if not new:
        print("ratchet OK: no findings beyond the baseline")
    return 1 if new else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lint_report")
    ap.add_argument("--all", action="store_true",
                    help="also list suppressed findings")
    ap.add_argument("--rule", default=None)
    ap.add_argument("--rules", nargs="*", default=None,
                    help="restrict to a rule FAMILY (several IDs) — the "
                         "ci_gate lint-concurrency and lint-taint checks "
                         "ratchet through this")
    ap.add_argument("--package", default=None,
                    help="analyze a different package tree")
    ap.add_argument("--root", default=None,
                    help="repo root for helm-gpu/docs cross-checks")
    ap.add_argument("--write-baseline", metavar="FILE", default=None,
                    help="snapshot current unsuppressed findings as the "
                         "ratchet baseline and exit")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="compare against a snapshot: exit 1 only on "
                         "findings NOT in the baseline")
    args = ap.parse_args(argv)

    rules = all_rules()
    wanted = list(args.rules) if args.rules else (
        [args.rule] if args.rule else None)
    findings = run_lint(package_dir=args.package, repo_root=args.root,
                        rules=wanted)

    if args.write_baseline:
        return write_baseline(args.write_baseline, findings)
    if args.baseline:
        return compare_baseline(args.baseline, findings)

    by_rule: dict[str, list] = {r: [] for r in rules}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)

    width = max(len(r) for r in rules)
    print(f"{'rule':<{width}}  live  supp  description")
    print("-" * (width + 60))
    for rule in sorted(by_rule):
        if wanted and rule not in wanted:
            continue
        fs = by_rule[rule]
        live = sum(1 for f in fs if not f.suppressed)
        supp = len(fs) - live
        mark = " " if live == 0 else "!"
        print(f"{rule:<{width}}  {live:>4}  {supp:>4}{mark} "
              f"{rules.get(rule, '?')}")

    live = [f for f in findings if not f.suppressed]
    if live:
        print("\nunsuppressed findings:")
        for f in live:
            print("  " + f.render())
    if args.all:
        supp = [f for f in findings if f.suppressed]
        if supp:
            print("\nsuppressed (audited) findings:")
            for f in supp:
                print("  " + f.render())
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
