"""useful_rows: the window's rows of real queries over the rows decoded
(the program's "decode.real_rows" and "decode.rows" counters, one entry a
decode call: padded query rows and inert copies are not real), in
percent."""


def read(ctx):
    rows = sum(ctx.phases.get("decode.rows", ()))
    real = sum(ctx.phases.get("decode.real_rows", ()))
    return 100.0 * real / rows if rows else None
