"""Utilities of the port: the flax <-> state_dict weight bridge, the TF1 and
Caffe imports, PNG and optical-flow helpers, the host spans (spans.py)."""
