"""Evaluation of the port: the classifier report, FID (plain, frozen and
EMA) and the sample-grid PNGs."""
