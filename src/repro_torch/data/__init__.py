"""Data of the port, numpy copies of the JAX package's `repro.data`
modules, so both packages draw the same bytes: `lm_data.py` (training
batches), `synthetic.py` (the seeded routing-benchmark generator),
`routing_bench.py` (the columns of the paper's Tables 2 and 5 and the
RouterBench tasks) and `prices.py` (Appendix B's model pools and prices)."""
