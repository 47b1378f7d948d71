"""Wall seconds, inside set-up, of the first call of each of the cell's
shapes (a batched request, or one fit a pad level): the graphs' warm-up,
capture and first replay, timed by the benchmark's span around each
call."""


def read(readings):
    if not readings.first_calls:
        return None
    return sum(seconds for _, seconds in readings.first_calls)
