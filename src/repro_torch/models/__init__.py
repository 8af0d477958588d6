"""Lowering IR, analytic CNN tables and the runnable model zoo."""
