# -*- coding: utf-8 -*-
#
# File extension registry (parity: reference syncopy/shared/filetypes.py:7).

__all__ = ["FILE_EXT", "data_classes_and_extensions"]

#: data classes and their on-disk extensions
data_classes_and_extensions = {
    "AnalogData": ".analog",
    "SpectralData": ".spectral",
    "CrossSpectralData": ".crossspectral",
    "TimeLockData": ".timelock",
    "SpikeData": ".spike",
    "EventData": ".event",
}

FILE_EXT = {
    "dir": ".spy",
    "info": ".info",
    "data": tuple(data_classes_and_extensions.values()),
}


def class_by_extension(ext):
    for cls, e in data_classes_and_extensions.items():
        if e == ext:
            return cls
    return None


def extension_by_class(clsname):
    return data_classes_and_extensions.get(clsname)
