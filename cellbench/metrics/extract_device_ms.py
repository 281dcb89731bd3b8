"""``extract_device_ms``: device milliseconds a call of window extraction:
the ops launched inside the program's ``fpca.extract`` range (the windows'
gather and their permuting copy to one flat matrix), over the traced
calls (``cellbench/spans.py``).  Nothing where the program opens no such
range."""

RANGE = "fpca.extract"


def read(ctx):
    spans = getattr(ctx, "spans", None)
    att = spans["attributed"] if spans else None
    if not att or not att["calls"] or RANGE not in att["device_ns"]:
        return None
    return att["device_ns"][RANGE] / att["calls"] / 1e6
