"""Environment steps collected per second of collection: the window's
frames over the summed seconds of ``run_cycle``'s collection."""


def read(record):
    cycles = record.get("cycles")
    if not cycles:
        return None
    return record["frames"] / sum(c["collect"] for c in cycles)
