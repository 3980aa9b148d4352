def read(run):
    """The factory's keys and the program's switching keys, ms: the
    constructor, then phase_ms key_census and key_build."""
    return run.factory_ms + run.phase_ms.get("key_census", 0.0) + \
        run.phase_ms.get("key_build", 0.0)
