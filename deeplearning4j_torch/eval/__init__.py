"""Evaluation suite of the port (``eval/evaluation.py``, ``eval/tools.py``)."""

from .evaluation import (ROC, Evaluation, EvaluationBinary,
                         EvaluationCalibration, Prediction, ROCBinary,
                         ROCMultiClass, RegressionEvaluation)
from .tools import export_evaluation_to_html, export_roc_charts_to_html

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "Prediction", "ROC", "ROCBinary", "ROCMultiClass",
           "RegressionEvaluation", "export_evaluation_to_html",
           "export_roc_charts_to_html"]
