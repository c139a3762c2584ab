"""Entry points: the split-serving driver (launch/serve.py)."""
