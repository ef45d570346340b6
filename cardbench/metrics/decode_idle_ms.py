"""decode_idle_ms.<cell>: the device idle under the program's
`lives.decode.` spans (the reads, the entropy decode, the uploads, the
IDCT's launches, the conversion) in the traced stretch, each idle instant
put down to the innermost span open (`spans.attribute`), in milliseconds
a rendered frame. None where the stretch holds no such span."""

from cardbench import spans

PREFIXES = ("lives.decode.",)


def read(rec):
    t = rec.get("trace")
    sp = t and t.get("spans")
    if not sp or not t["frames"] or not any(
            n.startswith(PREFIXES) for n in sp["names"]):
        return None
    return spans.layer_ms(sp, PREFIXES, t["frames"])
