"""The most device memory PyTorch's allocator held at once over set-up
and window, on the fullest card, in GiB."""


def read(w):
    return w.peak_bytes / 2 ** 30
