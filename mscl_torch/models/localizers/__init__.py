"""Temporal action localization: BMN, BSN's TEM and PEM, and SSN (port of
``mscl_tpu/models/localizers``)."""
from .base import parse_losses_localizer
from .bmn import BMN, build_interp1d_mask, build_match_map
from .bsn import PEM, TEM
from .ssn import SSN, SSNHead, SSNLoss, stpp_train

__all__ = ['BMN', 'build_interp1d_mask', 'build_match_map',
           'parse_losses_localizer', 'TEM', 'PEM', 'SSN', 'SSNHead',
           'SSNLoss', 'stpp_train']
