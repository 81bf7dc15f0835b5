"""The llama.cpp-parity sampling chain."""
