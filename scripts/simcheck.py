#!/usr/bin/env python3
"""Measure stripped-line similarity between repo files and same-named reference files.

Method: strip comments/docstrings/blank
lines, then count repo lines that fall inside contiguous matching blocks (difflib
SequenceMatcher) against the reference file, as a fraction of repo lines.
"""
from __future__ import annotations

import difflib
import io
import sys
import tokenize
from pathlib import Path

REF = Path("/root/reference/src/kaptive")
REPO = Path("/root/repo/kaptive_tpu")

PAIRS = [
    ("client.py", "client.py"),
    ("cli.py", "cli.py"),
    ("db/manager.py", "db/manager.py"),
    ("db/cli.py", "db/cli.py"),
    ("db/models.py", "db/models.py"),
    ("bgc/predictor.py", "bgc/predictor.py"),
    ("bgc/annotate.py", "bgc/annotate.py"),
    ("bgc/trainer.py", "bgc/trainer.py"),
    ("serotyping/io.py", "serotyping/io.py"),
    ("serotyping/models.py", "serotyping/models.py"),
    ("db/core.py", "db/core.py"),
    ("core/seq.py", "core/seq.py"),
    ("core/interval.py", "core/interval.py"),
    ("core/kmers.py", "core/kmers.py"),
    ("core/alignment.py", "core/alignment.py"),
    ("core/pairwise.py", "core/pairwise.py"),
    ("core/genome.py", "core/genome.py"),
    ("core/collections.py", "core/collections.py"),
    ("compare.py", "compare.py"),
    ("plotting.py", "plotting.py"),
    ("serotyping/core.py", "serotyping/core.py"),
    ("serotyping/cli.py", "serotyping/cli.py"),
]


def stripped_lines(path: Path) -> list[str]:
    src = path.read_text()
    # Remove comments and docstrings via tokenize; fall back to raw on failure.
    out = src
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(src).readline))
        drop = []  # (start, end) positions to blank
        prev_significant = None
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                drop.append((tok.start, tok.end))
            elif tok.type == tokenize.STRING:
                # docstring: first statement token at start of a logical line
                if prev_significant in (None, "NEWLINE", "INDENT", "DEDENT", "NL"):
                    drop.append((tok.start, tok.end))
            if tok.type not in (tokenize.COMMENT, tokenize.NL):
                prev_significant = tokenize.tok_name[tok.type]
        lines = src.splitlines()
        for (srow, scol), (erow, ecol) in drop:
            for r in range(srow, erow + 1):
                line = lines[r - 1]
                a = scol if r == srow else 0
                b = ecol if r == erow else len(line)
                lines[r - 1] = line[:a] + " " * (b - a) + line[b:]
        out = "\n".join(lines)
    except Exception:
        pass
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def similarity(repo_file: Path, ref_file: Path) -> tuple[float, int, int]:
    a = stripped_lines(repo_file)
    b = stripped_lines(ref_file)
    if not a:
        return 0.0, 0, 0
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    shared = sum(bl.size for bl in sm.get_matching_blocks())
    return shared / len(a), shared, len(a)


def main() -> None:
    sel = sys.argv[1:] or None
    rows = []
    for repo_rel, ref_rel in PAIRS:
        if sel and not any(s in repo_rel for s in sel):
            continue
        rp, fp = REPO / repo_rel, REF / ref_rel
        if not rp.exists() or not fp.exists():
            continue
        frac, shared, total = similarity(rp, fp)
        rows.append((frac, repo_rel, shared, total))
    rows.sort(reverse=True)
    for frac, name, shared, total in rows:
        flag = " <-- OVER 25%" if frac > 0.25 else ""
        print(f"{frac * 100:5.1f}%  {name:28s} ({shared}/{total} lines){flag}")


if __name__ == "__main__":
    main()
