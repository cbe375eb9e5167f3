"""The port's host data path: catalogs, decoding without an imaging
library, the reference library's resizes, loaders and the train mapper."""
