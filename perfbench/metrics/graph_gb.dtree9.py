"""Device memory the pack's captured graphs hold at the window's end, in
GB: the program's counters `engine.graph_bytes_captured` less
`engine.graph_bytes_released` (each graph's static inputs and memory
pool, counted when captured and when evicted).  None where the program
counts no such bytes."""


def read(run):
    captured = run.counters.get("engine.graph_bytes_captured")
    if captured is None:
        return None
    released = run.counters.get("engine.graph_bytes_released", (0, 0))
    return (captured[1] - released[1]) / 1e9
