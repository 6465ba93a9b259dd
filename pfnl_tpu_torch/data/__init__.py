"""Dataset helpers of the port."""
