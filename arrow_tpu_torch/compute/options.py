"""FunctionOptions classes (counterpart of ``arrow_tpu/compute/options.py``;
pyarrow.compute API parity).

Reference analogue: the serializable FunctionOptions subclasses declared in
compute/api_aggregate.h, api_vector.h:37-403, api_scalar.h. Each is a
light named container that lowers to kernel kwargs (``to_kwargs``), which
``call_function`` and the compute wrappers accept in place of a dict."""

from __future__ import annotations

from typing import Any, Dict, Sequence


class FunctionOptions:
    _fields: Sequence[str] = ()

    def to_kwargs(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in self._fields
                if getattr(self, f) is not None}

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._fields)
        return f"{type(self).__name__}({inner})"


def _options(name: str, fields: Sequence[str], defaults: Dict[str, Any]):
    def __init__(self, *args, **kwargs):
        vals = dict(defaults)
        for f, a in zip(fields, args):
            vals[f] = a
        vals.update(kwargs)
        unknown = set(vals) - set(fields)
        if unknown:
            raise TypeError(f"{name}: unknown options {sorted(unknown)}")
        for f in fields:
            setattr(self, f, vals.get(f))
    cls = type(name, (FunctionOptions,),
               {"__init__": __init__, "_fields": tuple(fields)})
    return cls


ScalarAggregateOptions = _options(
    "ScalarAggregateOptions", ["skip_nulls", "min_count"],
    {"skip_nulls": True, "min_count": 1})
CountOptions = _options("CountOptions", ["mode"], {"mode": "only_valid"})
VarianceOptions = _options(
    "VarianceOptions", ["ddof", "skip_nulls", "min_count"],
    {"ddof": 0, "skip_nulls": True, "min_count": 0})
QuantileOptions = _options(
    "QuantileOptions", ["q", "interpolation", "skip_nulls", "min_count"],
    {"q": 0.5, "interpolation": "linear", "skip_nulls": True,
     "min_count": 0})
TDigestOptions = _options(
    "TDigestOptions", ["q", "delta", "buffer_size", "skip_nulls",
                       "min_count"],
    {"q": 0.5, "delta": 100, "buffer_size": 500, "skip_nulls": True,
     "min_count": 0})
IndexOptions = _options("IndexOptions", ["value"], {})
FilterOptions = _options("FilterOptions", ["null_selection_behavior"],
                         {"null_selection_behavior": "drop"})
TakeOptions = _options("TakeOptions", ["boundscheck"],
                       {"boundscheck": True})
SortOptions = _options("SortOptions", ["sort_keys", "null_placement"],
                       {"sort_keys": None, "null_placement": "at_end"})
ArraySortOptions = _options(
    "ArraySortOptions", ["order", "null_placement"],
    {"order": "ascending", "null_placement": "at_end"})
SelectKOptions = _options("SelectKOptions", ["k", "sort_keys"],
                          {"k": 1, "sort_keys": None})
RankOptions = _options(
    "RankOptions", ["sort_keys", "null_placement", "tiebreaker"],
    {"sort_keys": "ascending", "null_placement": "at_end",
     "tiebreaker": "first"})
PartitionNthOptions = _options(
    "PartitionNthOptions", ["pivot", "null_placement"],
    {"pivot": 0, "null_placement": "at_end"})
CastOptions = _options(
    "CastOptions", ["to_type", "target_type", "safe"],
    {"to_type": None, "target_type": None, "safe": True})
RoundOptions = _options(
    "RoundOptions", ["ndigits", "round_mode"],
    {"ndigits": 0, "round_mode": "half_to_even"})
RoundToMultipleOptions = _options(
    "RoundToMultipleOptions", ["multiple", "round_mode"],
    {"multiple": 1.0, "round_mode": "half_to_even"})
MatchSubstringOptions = _options(
    "MatchSubstringOptions", ["pattern", "ignore_case"],
    {"pattern": "", "ignore_case": False})
TrimOptions = _options("TrimOptions", ["characters"], {"characters": ""})
PadOptions = _options(
    "PadOptions", ["width", "padding", "lean_left_on_odd_padding"],
    {"width": 0, "padding": " ", "lean_left_on_odd_padding": True})
SliceOptions = _options(
    "SliceOptions", ["start", "stop", "step"],
    {"start": 0, "stop": None, "step": 1})
ReplaceSubstringOptions = _options(
    "ReplaceSubstringOptions", ["pattern", "replacement",
                                "max_replacements"],
    {"pattern": "", "replacement": "", "max_replacements": None})
SetLookupOptions = _options(
    "SetLookupOptions", ["value_set", "skip_nulls"],
    {"value_set": (), "skip_nulls": False})
ElementWiseAggregateOptions = _options(
    "ElementWiseAggregateOptions", ["skip_nulls"], {"skip_nulls": True})
DayOfWeekOptions = _options(
    "DayOfWeekOptions", ["count_from_zero", "week_start"],
    {"count_from_zero": True, "week_start": 1})
AssumeTimezoneOptions = _options(
    "AssumeTimezoneOptions", ["timezone", "ambiguous", "nonexistent"],
    {"timezone": "UTC", "ambiguous": "raise", "nonexistent": "raise"})
NullOptions = _options("NullOptions", ["nan_is_null"],
                       {"nan_is_null": False})
DictionaryEncodeOptions = _options(
    "DictionaryEncodeOptions", ["null_encoding_behavior"],
    {"null_encoding_behavior": "mask"})
PairwiseOptions = _options("PairwiseOptions", ["period"], {"period": 1})
CumulativeOptions = _options(
    "CumulativeOptions", ["start", "skip_nulls"],
    {"start": None, "skip_nulls": False})
ModeOptions = _options(
    "ModeOptions", ["n", "skip_nulls", "min_count"],
    {"n": 1, "skip_nulls": True, "min_count": 0})
BetweenOptions = _options("BetweenOptions", ["inclusive"],
                          {"inclusive": "both"})
PivotWiderOptions = _options(
    "PivotWiderOptions", ["key_names", "unexpected_key_behavior"],
    {"key_names": (), "unexpected_key_behavior": "ignore"})
SkewOptions = _options(
    "SkewOptions", ["skip_nulls", "biased", "min_count"],
    {"skip_nulls": True, "biased": True, "min_count": 0})


# remaining pyarrow.compute FunctionOptions classes (api_scalar.h /
# api_vector.h option structs)
CumulativeSumOptions = _options(
    "CumulativeSumOptions", ["start", "skip_nulls"],
    {"start": None, "skip_nulls": False})
ExtractRegexOptions = _options("ExtractRegexOptions", ["pattern"], {})
ExtractRegexSpanOptions = _options(
    "ExtractRegexSpanOptions", ["pattern"], {})
InversePermutationOptions = _options(
    "InversePermutationOptions", ["max_index", "output_type"],
    {"max_index": None, "output_type": None})
JoinOptions = _options(
    "JoinOptions", ["null_handling", "null_replacement"],
    {"null_handling": "emit_null", "null_replacement": ""})
ListFlattenOptions = _options(
    "ListFlattenOptions", ["recursive"], {"recursive": False})
ListSliceOptions = _options(
    "ListSliceOptions", ["start", "stop", "step",
                         "return_fixed_size_list"],
    {"start": 0, "stop": None, "step": 1,
     "return_fixed_size_list": None})
MakeStructOptions = _options(
    "MakeStructOptions", ["field_names", "field_nullability",
                          "field_metadata"],
    {"field_names": (), "field_nullability": None,
     "field_metadata": None})
MapLookupOptions = _options(
    "MapLookupOptions", ["query_key", "occurrence"],
    {"query_key": None, "occurrence": "first"})
RandomOptions = _options(
    "RandomOptions", ["initializer"], {"initializer": "system"})
RankQuantileOptions = _options(
    "RankQuantileOptions", ["sort_keys", "null_placement"],
    {"sort_keys": "ascending", "null_placement": "at_end"})
ReplaceSliceOptions = _options(
    "ReplaceSliceOptions", ["start", "stop", "replacement"],
    {"start": 0, "stop": 0, "replacement": ""})
RoundBinaryOptions = _options(
    "RoundBinaryOptions", ["round_mode"],
    {"round_mode": "half_to_even"})
RoundTemporalOptions = _options(
    "RoundTemporalOptions",
    ["multiple", "unit", "week_starts_monday",
     "ceil_is_strictly_greater", "calendar_based_origin"],
    {"multiple": 1, "unit": "day", "week_starts_monday": True,
     "ceil_is_strictly_greater": False,
     "calendar_based_origin": False})
RunEndEncodeOptions = _options(
    "RunEndEncodeOptions", ["run_end_type"], {"run_end_type": None})
ScatterOptions = _options(
    "ScatterOptions", ["max_index"], {"max_index": None})
SplitOptions = _options(
    "SplitOptions", ["max_splits", "reverse"],
    {"max_splits": None, "reverse": False})
SplitPatternOptions = _options(
    "SplitPatternOptions", ["pattern", "max_splits", "reverse"],
    {"pattern": None, "max_splits": None, "reverse": False})
StrftimeOptions = _options(
    "StrftimeOptions", ["format", "locale"],
    {"format": "%Y-%m-%dT%H:%M:%S", "locale": "C"})
StrptimeOptions = _options(
    "StrptimeOptions", ["format", "unit", "error_is_null"],
    {"format": "%Y-%m-%dT%H:%M:%S", "unit": "us",
     "error_is_null": False})
StructFieldOptions = _options(
    "StructFieldOptions", ["indices"], {"indices": ()})
Utf8NormalizeOptions = _options(
    "Utf8NormalizeOptions", ["form"], {"form": "NFC"})
WeekOptions = _options(
    "WeekOptions", ["week_starts_monday", "count_from_zero",
                    "first_week_is_fully_in_year"],
    {"week_starts_monday": True, "count_from_zero": False,
     "first_week_is_fully_in_year": False})
WinsorizeOptions = _options(
    "WinsorizeOptions", ["lower_limit", "upper_limit"],
    {"lower_limit": 0.0, "upper_limit": 1.0})
ZeroFillOptions = _options(
    "ZeroFillOptions", ["width", "padding"],
    {"width": 0, "padding": "0"})


__all__ = ["FunctionOptions"] + sorted(
    n for n, v in list(globals().items())
    if isinstance(v, type) and issubclass(v, FunctionOptions)
    and v is not FunctionOptions)
