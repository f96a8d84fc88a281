"""``free_memory_ms.score``: mean milliseconds a score call spends in the
card's free-memory query (the program's ``free_memory`` spans, summed in a
call: ``band.ring_budget``'s ``torch.cuda.mem_get_info``), over the
window's calls.  Host clock.  0 on the CPU, where no ring is
planned."""

from benchmark import program_spans

instrument = program_spans.instrument


def read(run):
    calls = program_spans.window(run)
    return None if calls is None else program_spans.mean(c.ms("free_memory") for c in calls)
