"""Evaluation of the port: the classifier report and FID (plain, frozen
and EMA)."""
