"""Device idle milliseconds per update between replays, from one replay's
last device operation to the next one's first, in the marked sub-window
(``program_trace.py``): the device waiting for the host's next launch.
The idle before the first replay and after the last (the closing
synchronisation) is left out."""


def read(record):
    program = record.get("program_trace")
    if program is None or not program.replays:
        return None
    return 1e3 * program.between_replays_s / record["profile_steps"]
