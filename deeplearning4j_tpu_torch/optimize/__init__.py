"""Training listeners (the port of ``deeplearning4j_tpu/optimize``).  So far
:mod:`.listeners`' SPI; the stock listeners, early stopping and the
solvers wait for ROADMAP A9."""
