"""Mean ms a wave of the port's `service.results` span (program_span:
`RouterService.submit_texts`' loop that builds a `RoutedResult` and its
engine request for each routed text, tokenising each text again for its
prompt), over the window's waves."""
from bench.metrics._program import span_ms_a_wave


def read(ctx):
    return span_ms_a_wave("service.results")
