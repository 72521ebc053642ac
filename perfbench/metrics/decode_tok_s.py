"""decode_tok_s: generated tokens streamed back to the host inside the
window, over the window (host clock); the window includes the prefills of
new batches and requests."""


def read(rec, suffix):
    if rec.kind != "decode" or not rec.window_s:
        return None
    return rec.tokens.get("decode", 0) / rec.window_s
