"""Utilities of the port: the flax <-> state_dict weight bridge."""
