"""Updates per second of the cycles' update phase: the window's updates
over the summed seconds of ``run_cycle``'s commit and updates."""


def read(record):
    cycles = record.get("cycles")
    if not cycles or not record.get("updates"):
        return None
    return record["updates"] / sum(c["update"] for c in cycles)
