"""encode_idle_ms.<cell>: the device idle under the program's
`lives.encode.` spans (the coefficient stage, the fetch, the Huffman
encode) and `lives.mux` (the AVI's write) in the traced stretch, in
milliseconds a rendered frame, as `decode_idle_ms` counts it. None where
the stretch holds no such span."""

from cardbench import spans

PREFIXES = ("lives.encode.", "lives.mux")


def read(rec):
    t = rec.get("trace")
    sp = t and t.get("spans")
    if not sp or not t["frames"] or not any(
            n.startswith(PREFIXES) for n in sp["names"]):
        return None
    return spans.layer_ms(sp, PREFIXES, t["frames"])
