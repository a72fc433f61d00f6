"""Collection's share of the window's cycles, in percent: the summed
seconds of ``OnlineTrainer.run_cycle``'s collection (reset included) over
those of collection plus commit and updates (``timings``, taken between
the trainer's own device synchronisations)."""


def read(record):
    cycles = record.get("cycles")
    if not cycles:
        return None
    collect = sum(c["collect"] for c in cycles)
    return 100.0 * collect / (collect + sum(c["update"] for c in cycles))
