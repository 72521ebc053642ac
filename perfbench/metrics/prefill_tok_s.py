"""prefill_tok_s: prompt tokens whose prefill finished inside the window,
over the window (host clock)."""


def read(rec, suffix):
    if rec.kind != "prefill" or not rec.window_s:
        return None
    return rec.tokens.get("prefill", 0) / rec.window_s
