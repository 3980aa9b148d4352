def read(run):
    """Parsing and the compiler's passes, ms (phase_ms["parse_compile"])."""
    return run.phase_ms.get("parse_compile")
