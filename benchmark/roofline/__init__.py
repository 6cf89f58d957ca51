"""The needed work of the port's kernels and the card's peaks
(``peaks.json``): the bounds the roofline shares divide by."""
