"""Share of the engine's executed batch slots that were bucket padding
over the window: ``ServingEngine.stats()``'s padded_slots over
executed_slots, taken as differences across the window, in %."""


def read(run):
    executed = run.counters["executed_slots"]
    if not executed:
        return None
    return 100.0 * run.counters["padded_slots"] / executed
