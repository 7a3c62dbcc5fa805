"""Rule registry of the port's lint.  Each rule is
``run(project, config) -> List[Finding]``; the engine applies pragmas and
the baseline afterwards.  The ids are the reference's
(`repro.analysis.rules`), each restated for the port's idiom."""
from . import (durable_write, graph_capture, host_sync, lock_discipline,
               schema_pin, swallow)

ALL_RULES = {
    "R1": host_sync.run,
    "R2": lock_discipline.run,
    "R3": schema_pin.run,
    "R4": graph_capture.run,
    "R5": swallow.run,
    "R6": durable_write.run,
}

__all__ = ["ALL_RULES"]
