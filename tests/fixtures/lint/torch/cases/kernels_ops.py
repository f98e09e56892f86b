"""A kernel wrapper module: every public function is a root."""


def gather_add(h, table):
    with open("/dev/null") as fh:
        fh.read()
    return h + table


def _private(h):
    print(h)
