"""EvaluationTools — counterpart of ``deeplearning4j_tpu/eval/tools.py``,
kept in the port as its own copy: HTML reports of ROC, precision-recall
and calibration results as inline SVG in one self-contained file.
"""

from __future__ import annotations

import html as _html
from typing import Optional, Sequence, Tuple

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>{title}</title>
<style>
body{{font-family:sans-serif;margin:24px;background:#fafafa}}
.card{{background:#fff;border:1px solid #ddd;display:inline-block;margin:8px;
padding:12px;vertical-align:top}}
h2,h3{{margin:6px}}
table{{border-collapse:collapse}} td,th{{padding:2px 10px;text-align:right}}
</style></head><body><h2>{title}</h2>{body}</body></html>"""


def _svg_curve(xs, ys, *, w=360, h=300, color="#d62728", diag=False,
               xlabel="", ylabel="") -> str:
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    sx = lambda x: 40 + x * (w - 55)
    sy = lambda y: h - 30 - y * (h - 45)
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    parts = [f'<svg width="{w}" height="{h}">']
    parts.append(f'<rect x="40" y="15" width="{w-55}" height="{h-45}" '
                 f'fill="none" stroke="#ccc"/>')
    if diag:
        parts.append(f'<line x1="{sx(0):.1f}" y1="{sy(0):.1f}" x2="{sx(1):.1f}" '
                     f'y2="{sy(1):.1f}" stroke="#bbb" stroke-dasharray="4"/>')
    parts.append(f'<polyline fill="none" stroke="{color}" stroke-width="1.8" '
                 f'points="{pts}"/>')
    for t in (0.0, 0.5, 1.0):
        parts.append(f'<text x="{sx(t)-6:.0f}" y="{h-14}" font-size="10">{t:g}</text>')
        parts.append(f'<text x="14" y="{sy(t)+4:.0f}" font-size="10">{t:g}</text>')
    parts.append(f'<text x="{w//2-20}" y="{h-2}" font-size="11">{_html.escape(xlabel)}</text>')
    parts.append(f'<text x="2" y="12" font-size="11">{_html.escape(ylabel)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def roc_chart_html(roc, title: str = "ROC") -> str:
    """One card: ROC curve + AUC (works for the binary ROC class)."""
    fpr, tpr = roc.roc_curve()
    auc = roc.auc()
    return (f'<div class="card"><h3>{_html.escape(title)} '
            f'(AUC={auc:.4f})</h3>'
            + _svg_curve(fpr, tpr, diag=True, xlabel="FPR", ylabel="TPR")
            + "</div>")


def pr_chart_html(roc, title: str = "Precision-Recall") -> str:
    rec, prec = roc.pr_curve()
    return (f'<div class="card"><h3>{_html.escape(title)}</h3>'
            + _svg_curve(rec, prec, color="#1f77b4", xlabel="recall",
                         ylabel="precision") + "</div>")


def calibration_chart_html(cal, title: str = "Reliability") -> str:
    conf, freq = cal.reliability()
    ok = np.isfinite(conf) & np.isfinite(freq)
    return (f'<div class="card"><h3>{_html.escape(title)}</h3>'
            + _svg_curve(conf[ok], freq[ok], color="#2ca02c", diag=True,
                         xlabel="confidence", ylabel="empirical frequency")
            + "</div>")


def export_roc_charts_to_html(roc, path: Optional[str] = None,
                              calibration=None,
                              title: str = "Evaluation report") -> str:
    """EvaluationTools.exportRocChartsToHtmlFile parity: ROC + PR (+ optional
    reliability) as one standalone HTML page; returns the HTML, writes it to
    ``path`` when given."""
    body = roc_chart_html(roc) + pr_chart_html(roc)
    if calibration is not None:
        body += calibration_chart_html(calibration)
    page = _PAGE.format(title=_html.escape(title), body=body)
    if path:
        with open(path, "w") as f:
            f.write(page)
    return page


def export_evaluation_to_html(evaluation, path: Optional[str] = None,
                              title: str = "Classification report") -> str:
    """Confusion-matrix + per-class P/R/F1 table as standalone HTML."""
    n = evaluation.num_classes
    cm = evaluation.confusion
    rows = ["<tr><th></th>" + "".join(f"<th>pred {j}</th>" for j in range(n))
            + "</tr>"]
    for i in range(n):
        rows.append(f"<tr><th>true {i}</th>"
                    + "".join(f"<td>{int(cm[i, j])}</td>" for j in range(n))
                    + "</tr>")
    stats = ["<tr><th>class</th><th>precision</th><th>recall</th><th>f1</th></tr>"]
    for c in range(n):
        stats.append(f"<tr><td>{c}</td><td>{evaluation.precision(c):.4f}</td>"
                     f"<td>{evaluation.recall(c):.4f}</td>"
                     f"<td>{evaluation.f1(c):.4f}</td></tr>")
    body = (f'<div class="card"><h3>accuracy {evaluation.accuracy():.4f}</h3>'
            f'<table>{"".join(rows)}</table></div>'
            f'<div class="card"><h3>per-class</h3><table>{"".join(stats)}</table></div>')
    page = _PAGE.format(title=_html.escape(title), body=body)
    if path:
        with open(path, "w") as f:
            f.write(page)
    return page
