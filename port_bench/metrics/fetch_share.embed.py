"""Share of the window the entry's single fetch of every embedding takes
on the device, %: the device seconds of the program's ``embed.fetch`` span
(the concatenation, the cast to float32 and the copy to the host) over the
window's wall time."""

from port_bench import program_spans


def read(summary, counts, config, traffic):
    sec = program_spans.device_s(program_spans.snapshot(),
                                 "embed.call/embed.fetch")
    if sec is None or not counts.get("window_s"):
        return None
    return sec / counts["window_s"] * 100.0
