"""Hyperparameter-optimization advisor: own copies of
``rafiki_tpu/advisor/gp.py`` and ``rafiki_tpu/advisor/advisor.py``."""
