"""Cost model, SPMD session drivers and the paper's applications."""
