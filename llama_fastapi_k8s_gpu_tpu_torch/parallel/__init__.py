"""Lane programs of the batched engines (parallel/batched.py)."""
