"""``python -m llama_fastapi_k8s_gpu_tpu_torch.lint`` — run the lint suite.

Exit status 0 when the tree has zero unsuppressed findings, 1 otherwise
(machine-consumable: CI gates on it).  stdlib-only, no torch or jax import,
runs in seconds on CPU.

Options:
  --json           one JSON object per finding on stdout (machine-readable)
  --all            include suppressed findings in the output
  --rule R [...]   restrict to specific rule IDs
  --package DIR    analyze a different package tree (fixture self-tests)
  --root DIR       repo root for helm-gpu/README/docs cross-checks
  --changed        incremental mode for the pre-commit loop: re-derive
                   interprocedural summaries only for files whose
                   content hash moved since the cached whole-package
                   pass (in practice: what `git diff --name-only`
                   names — the diff is reported, the hashes decide);
                   every other file's summaries come from the cache the
                   last pass wrote (.lfkt_torch_lint_cache.json,
                   repo-root, gitignored).  The finding set is IDENTICAL
                   to a full run — pinned by tests/test_torch_lint.py
  --list-rules     print the rule catalog and exit
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .core import all_rules, run_lint

CACHE_NAME = ".lfkt_torch_lint_cache.json"
CACHE_SCHEMA = 1


def _git_changed(root: str) -> list[str]:
    """Repo-relative paths `git diff --name-only HEAD` (plus untracked)
    reports — ADVISORY ONLY, for the operator-facing message: content
    hashes (not this list) decide what actually re-derives, so a stale
    or failed diff can only mislabel the message, never the findings."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=5)
        extra = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.TimeoutExpired):
        return []
    out = []
    for proc in (diff, extra):
        if proc.returncode == 0:
            out.extend(ln.strip() for ln in proc.stdout.splitlines()
                       if ln.strip())
    return sorted(set(out))


def _load_cache(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if doc.get("schema") == CACHE_SCHEMA else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llama_fastapi_k8s_gpu_tpu_torch.lint")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="include suppressed findings")
    ap.add_argument("--rule", nargs="*", default=None)
    ap.add_argument("--package", default=None)
    ap.add_argument("--root", default=None)
    ap.add_argument("--changed", action="store_true",
                    help="incremental pre-commit mode (see module help)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(all_rules().items()):
            print(f"{rule}  {desc}")
        return 0

    incremental = None
    cache_path = None
    if args.changed:
        root = args.root
        if root is None:
            pkg = args.package or os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))
            cand = os.path.dirname(os.path.abspath(pkg))
            root = cand if os.path.isdir(os.path.join(cand, "tests")) \
                else None
        cache_path = os.path.join(root or ".", CACHE_NAME)
        incremental = {"cache": _load_cache(cache_path)}
        changed = _git_changed(root) if root else []
        if changed and not args.json:
            print(f"--changed: git names {len(changed)} changed file(s); "
                  "content hashes decide reuse", file=sys.stderr)

    findings = run_lint(package_dir=args.package, repo_root=args.root,
                        rules=args.rule, incremental=incremental)

    if incremental is not None and incremental.get("out") is not None \
            and cache_path is not None:
        doc = {"schema": CACHE_SCHEMA, **incremental["out"]}
        try:
            with open(cache_path, "w", encoding="utf-8") as f:
                json.dump(doc, f)
        except OSError as e:
            print(f"--changed: cache not written ({e})", file=sys.stderr)
        reused = incremental.get("reused") or []
        print(f"--changed: reused cached summaries for "
              f"{len(reused)} file(s)", file=sys.stderr)
    live = [f for f in findings if not f.suppressed]
    shown = findings if args.all else live
    if args.json:
        for f in shown:
            print(json.dumps(vars(f)))
    else:
        for f in shown:
            print(f.render())
        n_sup = sum(1 for f in findings if f.suppressed)
        print(f"lfkt-lint: {len(live)} finding(s), {n_sup} suppressed",
              file=sys.stderr)
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
