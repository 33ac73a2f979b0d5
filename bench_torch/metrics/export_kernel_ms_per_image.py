"""End to end, from the device trace: milliseconds of device time in
kernels (copies apart) per image the window's export call wrote, over
every kernel and every image of the window: the card's cost of an
exported image, what an export pays where the card is shared or billed
by its time. The host's clock does not enter it."""


def read(record):
    tr = record.get("trace")
    images = record.get("images")
    if not tr or not tr.get("kernel_s") or not images:
        return None
    return 1e3 * tr["kernel_s"] / images
