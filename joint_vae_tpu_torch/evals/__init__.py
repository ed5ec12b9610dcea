"""Evaluation engines: accuracy, OOD and misclassification detection
(``engines.py``), and the ODIN input-perturbation scores (``odin.py``)."""
