"""entropy_ms.<cell>: the host self time of the program's
`lives.decode.entropy` spans (the lane's Huffman decode and pack, its
reads left out) in the traced stretch, in milliseconds a rendered frame.
None where the stretch holds no such span."""

from cardbench import spans


def read(rec):
    t = rec.get("trace")
    sp = t and t.get("spans")
    if not sp or not t["frames"] or "lives.decode.entropy" not in \
            sp["names"]:
        return None
    return spans.layer_ms(sp, ("lives.decode.entropy",), t["frames"],
                          "self_s")
