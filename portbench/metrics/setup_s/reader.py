"""setup_s: the seconds from the process's start to the window's start
(imports, the card, the program's libraries, the data made from the seed,
one warm call of each of the cell's call kinds)."""


def read(ctx):
    return ctx.setup_s
