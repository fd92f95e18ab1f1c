"""Pure-python validator for Prometheus text (0.0.4) and OpenMetrics
expositions — the port's copy of ``deeplearning4j_tpu/obs/promcheck.py``,
the lint that keeps every scraped ``.prom`` artifact honest.

A scrape that a real Prometheus would reject (duplicate families, broken
label escaping, malformed exemplars, non-cumulative histogram buckets) is
worse than no scrape: dashboards silently drop the series and the gap looks
like "no traffic". Tests run it over live ``/metrics`` bodies, and
``chip_smoke.py`` over every ``/metrics`` body it reads on the card.

Checks:

- metric/label **names** match the Prometheus grammar; label **values** use
  only the legal escapes (``\\\\``, ``\\"``, ``\\n``) and are fully quoted;
- one ``# TYPE`` per family, metadata before samples, family blocks
  contiguous (a family reopened later in the text is a duplicate);
- histogram families: ``le`` present on ``_bucket`` samples, cumulative
  counts non-decreasing as ``le`` grows, ``+Inf`` bucket present and equal
  to ``_count``;
- sample values parse (float, ``+Inf``/``-Inf``/``NaN``);
- **exemplars** (`` # {labels} value [ts]``): OpenMetrics only, only on
  ``_bucket``/``_total`` samples, labelset <= 128 chars, value parses;
- OpenMetrics framing: terminating ``# EOF``, nothing after it, no blank
  lines.

Format is auto-detected by the ``# EOF`` terminator unless forced. Stdlib
only; also a CLI: ``python -m deeplearning4j_torch.obs.promcheck f.prom ...``.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_value(tok: str) -> Optional[float]:
    if tok in ("+Inf", "Inf"):
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok in ("NaN", "nan"):
        return float("nan")
    try:
        return float(tok)
    except ValueError:
        return None


def _parse_labels(s: str) -> Tuple[Optional[List[Tuple[str, str]]], int, str]:
    """Parse ``{k="v",...}`` at the start of ``s``.

    Returns ``(labels, end_index, error)``; ``labels`` is ``None`` on error.
    """
    assert s[0] == "{"
    i, labels = 1, []
    while True:
        if i >= len(s):
            return None, i, "unterminated label set"
        if s[i] == "}":
            return labels, i + 1, ""
        j = i
        while j < len(s) and s[j] not in "=,}":
            j += 1
        name = s[i:j]
        if not _LABEL_RE.match(name):
            return None, i, f"invalid label name {name!r}"
        if j >= len(s) or s[j] != "=":
            return None, j, f"expected '=' after label {name!r}"
        j += 1
        if j >= len(s) or s[j] != '"':
            return None, j, f"label {name!r} value must be double-quoted"
        j += 1
        val = []
        while True:
            if j >= len(s):
                return None, j, f"unterminated value for label {name!r}"
            c = s[j]
            if c == "\\":
                if j + 1 >= len(s) or s[j + 1] not in ('\\', '"', 'n'):
                    return None, j, (f"invalid escape in label {name!r} "
                                     f"value (only \\\\ \\\" \\n allowed)")
                val.append({"n": "\n"}.get(s[j + 1], s[j + 1]))
                j += 2
            elif c == '"':
                j += 1
                break
            elif c == "\n":
                return None, j, f"unescaped newline in label {name!r} value"
            else:
                val.append(c)
                j += 1
        labels.append((name, "".join(val)))
        if j < len(s) and s[j] == ",":
            i = j + 1
        elif j < len(s) and s[j] == "}":
            i = j
        else:
            return None, j, "expected ',' or '}' after label value"


class _Checker:
    def __init__(self, openmetrics: bool):
        self.om = openmetrics
        self.errors: List[str] = []
        self.types: Dict[str, str] = {}
        self.closed: set = set()
        self.current: Optional[str] = None
        self.sampled: set = set()
        # (family, frozen labels minus le) -> [(le_value, cum_count)]
        self.hist: Dict[Tuple[str, tuple], List[Tuple[float, float]]] = {}
        self.hist_counts: Dict[Tuple[str, tuple], float] = {}

    def err(self, lineno: int, msg: str) -> None:
        self.errors.append(f"line {lineno}: {msg}")

    def _family_of(self, sample: str) -> str:
        for suf in _HIST_SUFFIXES:
            if sample.endswith(suf):
                base = sample[:-len(suf)]
                if self.types.get(base) == "histogram":
                    return base
        if sample.endswith("_total"):
            base = sample[:-len("_total")]
            if self.types.get(base) == "counter":
                return base
        return sample

    def _enter_family(self, fam: str, lineno: int) -> None:
        if fam == self.current:
            return
        if self.current is not None:
            self.closed.add(self.current)
        if fam in self.closed:
            self.err(lineno, f"family {fam!r} appears twice "
                             f"(blocks must be contiguous)")
        self.current = fam

    def meta(self, lineno: int, line: str) -> None:
        parts = line.split(None, 3)
        if len(parts) < 3:
            self.err(lineno, f"malformed metadata line: {line!r}")
            return
        word, fam = parts[1], parts[2]
        if not _NAME_RE.match(fam):
            self.err(lineno, f"invalid family name {fam!r}")
            return
        self._enter_family(fam, lineno)
        if word == "TYPE":
            kind = parts[3].strip() if len(parts) > 3 else ""
            if fam in self.types:
                self.err(lineno, f"duplicate # TYPE for family {fam!r}")
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped", "unknown", "info", "stateset",
                            "gaugehistogram"):
                self.err(lineno, f"unknown type {kind!r} for {fam!r}")
            self.types[fam] = kind
            if fam in self.sampled:
                self.err(lineno, f"# TYPE for {fam!r} after its samples")

    def sample(self, lineno: int, line: str) -> None:
        m = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line)
        if not m:
            self.err(lineno, f"invalid sample name: {line!r}")
            return
        name = m.group(0)
        rest = line[m.end():]
        labels: List[Tuple[str, str]] = []
        if rest.startswith("{"):
            parsed, end, perr = _parse_labels(rest)
            if parsed is None:
                self.err(lineno, perr)
                return
            labels, rest = parsed, rest[end:]
        seen = set()
        for k, _ in labels:
            if k in seen:
                self.err(lineno, f"duplicate label {k!r} on {name}")
            seen.add(k)
        exemplar = None
        if " # " in rest:
            rest, _, ex = rest.partition(" # ")
            exemplar = ex.strip()
        toks = rest.split()
        if not toks:
            self.err(lineno, f"sample {name} has no value")
            return
        if len(toks) > 2:
            self.err(lineno, f"trailing tokens after sample {name}")
            return
        value = _parse_value(toks[0])
        if value is None:
            self.err(lineno, f"unparseable value {toks[0]!r} for {name}")
            return
        if len(toks) == 2 and _parse_value(toks[1]) is None:
            self.err(lineno, f"unparseable timestamp {toks[1]!r} for {name}")
        fam = self._family_of(name)
        self._enter_family(fam, lineno)
        self.sampled.add(fam)
        kind = self.types.get(fam)
        if kind == "histogram" and name.endswith("_bucket"):
            le = dict(labels).get("le")
            if le is None:
                self.err(lineno, f"{name} sample missing 'le' label")
            else:
                bound = _parse_value(le)
                if bound is None:
                    self.err(lineno, f"unparseable le={le!r} on {name}")
                else:
                    key = (fam, tuple(sorted((k, v) for k, v in labels
                                             if k != "le")))
                    series = self.hist.setdefault(key, [])
                    if series and (bound < series[-1][0]
                                   or value < series[-1][1]):
                        self.err(lineno, f"histogram {fam} buckets not "
                                         f"cumulative/ordered at le={le}")
                    series.append((bound, value))
        elif kind == "histogram" and name.endswith("_count"):
            key = (fam, tuple(sorted(labels)))
            self.hist_counts[key] = value
        if exemplar is not None:
            self.exemplar(lineno, name, kind, exemplar)

    def exemplar(self, lineno: int, name: str, kind: Optional[str],
                 ex: str) -> None:
        if not self.om:
            self.err(lineno, f"exemplar on {name} but exposition is not "
                             f"OpenMetrics")
        if not (name.endswith("_bucket") or name.endswith("_total")):
            self.err(lineno, f"exemplar not allowed on {name} "
                             f"(only _bucket/_total samples)")
        if not ex.startswith("{"):
            self.err(lineno, f"exemplar on {name} must start with a labelset")
            return
        parsed, end, perr = _parse_labels(ex)
        if parsed is None:
            self.err(lineno, f"exemplar labels: {perr}")
            return
        runes = sum(len(k) + len(v) for k, v in parsed)
        if runes > 128:
            self.err(lineno, f"exemplar labelset on {name} exceeds "
                             f"128 characters ({runes})")
        toks = ex[end:].split()
        if not toks or len(toks) > 2:
            self.err(lineno, f"exemplar on {name} needs 'value [timestamp]'")
            return
        for tok in toks:
            if _parse_value(tok) is None:
                self.err(lineno, f"unparseable exemplar token {tok!r}")

    def finish_histograms(self) -> None:
        for (fam, lbls), series in self.hist.items():
            if not any(b == float("inf") for b, _ in series):
                self.errors.append(f"histogram {fam}{dict(lbls)} has no "
                                   f"+Inf bucket")
                continue
            inf_cum = max(c for b, c in series if b == float("inf"))
            count = self.hist_counts.get((fam, lbls))
            if count is not None and count != inf_cum:
                self.errors.append(
                    f"histogram {fam}{dict(lbls)}: _count {count} != "
                    f"+Inf bucket {inf_cum}")


def check_text(text: str, openmetrics: Optional[bool] = None) -> List[str]:
    """Validate an exposition; returns a list of error strings (empty=ok)."""
    stripped = text.rstrip("\n")
    if openmetrics is None:
        openmetrics = stripped.endswith("# EOF")
    ck = _Checker(openmetrics)
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    saw_eof = False
    for lineno, line in enumerate(lines, 1):
        if saw_eof:
            ck.err(lineno, "content after # EOF")
            break
        if line == "# EOF":
            saw_eof = True
            continue
        if not line.strip():
            if openmetrics:
                ck.err(lineno, "blank line (forbidden in OpenMetrics)")
            continue
        if line.startswith("# HELP") or line.startswith("# TYPE") \
                or line.startswith("# UNIT"):
            ck.meta(lineno, line)
        elif line.startswith("#"):
            continue  # free-form comment (prometheus 0.0.4)
        else:
            ck.sample(lineno, line)
    if openmetrics and not saw_eof:
        ck.errors.append("missing terminating # EOF")
    ck.finish_histograms()
    return ck.errors


def check_file(path: str, openmetrics: Optional[bool] = None) -> List[str]:
    with open(path) as f:
        return check_text(f.read(), openmetrics)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m deeplearning4j_torch.obs.promcheck "
              "FILE.prom [...]", file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        errors = check_file(path)
        if errors:
            failed = True
            for e in errors:
                print(f"{path}: {e}", file=sys.stderr)
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
