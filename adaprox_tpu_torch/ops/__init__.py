"""Operators: prox functions, smooth oracles, the accumulation policy and K1."""
