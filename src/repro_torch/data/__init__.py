"""Training data of the port: `lm_data.py` is a copy of the JAX package's
`repro.data.lm_data` (numpy only), so both packages draw the same batches
byte for byte."""
