"""Mean ms a wave of the port's `encoder.tokenize` span (program_span:
`QueryEncoder.embed_texts`' md5 tokenising of the wave's texts on the
host, before the encoder's device work), over the window's waves."""
from bench.metrics._program import span_ms_a_wave


def read(ctx):
    return span_ms_a_wave("encoder.tokenize")
