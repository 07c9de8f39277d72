# -*- coding: utf-8 -*-
# Shared infrastructure: parsers, errors, logging, tools, decorators.
