"""Plan node options (counterpart of ``arrow_tpu/acero/options.py``). A table
source holds a host ``Table`` or ``RecordBatch``, or a ``DeviceBatch``; a
scan source holds a dataset (``dataset.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..device.column import DeviceBatch
from ..table import RecordBatch, Table
from .expression import Expression
from .source_cache import table_of, uploaded_column


class ExecNodeOptions:
    """The base of every plan node's options (acero/options.h:64)."""


class TableSourceNodeOptions(ExecNodeOptions):
    """A plan source: a host ``Table`` or ``RecordBatch`` (``table``), or a
    DeviceBatch already made (``batch``). A host source's columns are
    prepared and uploaded once a device, and kept a column by
    ``source_cache``: a repeated run, and every source of the same table,
    reuses their tensors and dictionaries, so their codes stay
    comparable. ``source_cache.release`` frees them."""

    def __init__(self, table):
        if isinstance(table, DeviceBatch):
            self.table = None
            self._batch = table
        elif isinstance(table, (Table, RecordBatch)):
            self.table = table if isinstance(table, Table) \
                else table_of(table)
            self._batch = None
        else:
            raise TypeError("a table source takes a Table, a RecordBatch "
                            f"or a DeviceBatch, not {type(table).__name__}")

    @property
    def is_host(self) -> bool:
        return self.table is not None

    @property
    def batch(self) -> DeviceBatch:
        """The source's DeviceBatch; a host source's upload to the card."""
        return self._batch if self._batch is not None else self.upload()

    @property
    def num_rows(self) -> int:
        return self.table.num_rows if self._batch is None \
            else int(self._batch.row_count)

    @property
    def names(self):
        return (self.table if self._batch is None
                else self._batch).schema.names

    def upload(self, device=None, rows=None) -> DeviceBatch:
        """The host source as a DeviceBatch on ``device`` (the card by
        default), over its columns' uploads there
        (``source_cache.uploaded_column``): all of its rows, or its rows
        ``rows`` = (start, stop)."""
        import torch
        from .. import default_device
        dev = default_device(device)
        n = self.table.num_rows if rows is None else rows[1] - rows[0]
        return DeviceBatch(
            self.table.schema,
            [uploaded_column(c, dev, rows) for c in self.table.columns],
            torch.tensor(n, dtype=torch.int32, device=dev))

    def select(self, names: Sequence[str]) -> "TableSourceNodeOptions":
        """A source of ``names`` alone: a host source is narrowed before
        it is uploaded."""
        if self._batch is not None:
            return TableSourceNodeOptions(self._batch.select(names))
        return TableSourceNodeOptions(self.table.select(names))


class RecordBatchReaderSourceNodeOptions(ExecNodeOptions):
    """A source that drains a ``RecordBatchReader`` (source_node.cc:582),
    once, into a host table source."""

    def __init__(self, reader, schema=None):
        self.reader = reader
        self.schema = schema
        self._source: Optional[TableSourceNodeOptions] = None

    def source(self) -> TableSourceNodeOptions:
        if self._source is None:
            batches = list(self.reader)
            schema = batches[0].schema if batches else (
                self.schema or self.reader.schema)
            self._source = TableSourceNodeOptions(
                Table.from_batches(batches, schema))
        return self._source


class ScanNodeOptions(ExecNodeOptions):
    """A dataset as a plan source (reference: dataset/scan_node.cc:123
    "scan", ``arrow_tpu/acero/options.py`` ``ScanNodeOptions``): the
    fragments that ``filter``'s partition pruning keeps, each uploaded a
    column once (``source_cache``) and filtered on the card, enter the
    plan as one device table of ``columns`` (every column where None)
    (``exec._execute_scan``). ``device`` is where the scan runs (the card
    where None); a plan's run sets it."""

    def __init__(self, dataset, columns=None, filter=None,
                 require_sequenced_output: bool = False, device=None):
        self.dataset = dataset
        self.columns = list(columns) if columns is not None else None
        self.filter = filter
        self.require_sequenced_output = require_sequenced_output
        self.device = device

    @property
    def names(self):
        return self.columns if self.columns is not None \
            else list(self.dataset.schema.names)

    @property
    def table(self):
        """The scan's rows as a host Table (the reference's property)."""
        return self.dataset.to_table(columns=self.columns,
                                     filter=self.filter, device=self.device)

    def select(self, names: Sequence[str]) -> "ScanNodeOptions":
        """The scan of ``names`` alone (its filter still reads what it
        reads)."""
        return ScanNodeOptions(self.dataset, names, self.filter,
                               self.require_sequenced_output, self.device)

    def on(self, device) -> "ScanNodeOptions":
        """The same scan run on ``device``."""
        return ScanNodeOptions(self.dataset, self.columns, self.filter,
                               self.require_sequenced_output, device)


class ConsumingSinkNodeOptions(ExecNodeOptions):
    """Push each output batch into ``consumer`` (sink_node.cc
    "consuming_sink"): it is called with each RecordBatch, and its
    ``finish`` is called, where it has one, when the plan is done."""

    def __init__(self, consumer):
        self.consumer = consumer


class PivotLongerRowTemplate:
    """One output row a template for each input row (acero/options.h):
    ``feature_values`` the literal strings of the feature columns,
    ``measurement_values`` the input columns (None for null) of the
    measurement columns."""

    def __init__(self, feature_values: Sequence[str],
                 measurement_values: Sequence[Optional[str]]):
        self.feature_values = list(feature_values)
        self.measurement_values = list(measurement_values)


class PivotLongerNodeOptions(ExecNodeOptions):
    """Wide to long (acero/options.h PivotLongerNodeOptions): every input
    column not read as a measurement, then the feature and measurement
    columns; each input row gives one row a template."""

    def __init__(self, row_templates, feature_field_names: Sequence[str],
                 measurement_field_names: Sequence[str]):
        self.row_templates = [
            t if isinstance(t, PivotLongerRowTemplate)
            else PivotLongerRowTemplate(*t) for t in row_templates]
        self.feature_field_names = list(feature_field_names)
        self.measurement_field_names = list(measurement_field_names)


class FilterNodeOptions(ExecNodeOptions):
    def __init__(self, filter_expression: Expression):
        self.filter_expression = filter_expression


class ProjectNodeOptions(ExecNodeOptions):
    def __init__(self, expressions: Sequence[Expression],
                 names: Optional[Sequence[str]] = None):
        self.expressions = [e if isinstance(e, Expression)
                            else Expression.literal(e) for e in expressions]
        self.names = list(names) if names is not None else None


class AggregateNodeOptions(ExecNodeOptions):
    """aggregates: (target, function, options, output_name) each, or
    (target, function, output_name). ``segment_keys`` (the reference's
    RowSegmenter) go in front of the grouping keys, and the output comes
    sorted by them."""

    def __init__(self, aggregates: Sequence[Tuple], keys: Sequence = (),
                 segment_keys: Sequence = ()):
        norm = []
        for agg in aggregates:
            if len(agg) == 4:
                target, fn, options, out_name = agg
            elif len(agg) == 3:
                target, fn, out_name = agg
                options = None
            else:
                raise ValueError("aggregate spec needs 3 or 4 elements")
            norm.append((target, fn, options or {}, out_name))
        self.aggregates = norm
        self.keys = [str(k) for k in keys]
        self.segment_keys = [str(k) for k in segment_keys]


def _sort_keys(keys) -> list:
    return [(k, "ascending") if isinstance(k, str) else (k[0], k[1])
            for k in keys]


class OrderByNodeOptions(ExecNodeOptions):
    def __init__(self, sort_keys: Sequence[Tuple[str, str]],
                 null_placement: str = "at_end"):
        self.sort_keys = _sort_keys(sort_keys)
        self.null_placement = null_placement


class FetchNodeOptions(ExecNodeOptions):
    def __init__(self, offset: int = 0, count: int = -1):
        self.offset = int(offset)
        self.count = int(count)


JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti")


class HashJoinNodeOptions(ExecNodeOptions):
    """An equi-join; the left input probes, the right input builds.
    ``filter`` is a residual predicate on each matched pair. An empty
    output list emits no columns of that side; None emits all."""

    def __init__(self, join_type: str = "inner",
                 left_keys: Sequence[str] = (),
                 right_keys: Sequence[str] = (),
                 left_output: Optional[Sequence[str]] = None,
                 right_output: Optional[Sequence[str]] = None,
                 output_suffix_for_left: str = "",
                 output_suffix_for_right: str = "",
                 disable_bloom_filter: bool = False,
                 filter: Optional[Expression] = None):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"bad join type {join_type!r}")
        self.join_type = join_type
        self.disable_bloom_filter = disable_bloom_filter
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.left_output = list(left_output) if left_output is not None \
            else None
        self.right_output = list(right_output) if right_output is not None \
            else None
        self.output_suffix_for_left = output_suffix_for_left
        self.output_suffix_for_right = output_suffix_for_right
        self.filter_expression = filter


class UnionNodeOptions(ExecNodeOptions):
    pass


class AsofJoinNodeOptions(ExecNodeOptions):
    """For each left row, the most recent right row with the same by-keys
    whose ``on`` value lies in ``[left on + tolerance, left on]`` for a
    tolerance of at most 0, or at most ``left on`` (and within ``left on +
    tolerance``) for a positive one, as the reference reads it."""

    def __init__(self, left_on: str, left_by: Sequence[str],
                 right_on: str, right_by: Sequence[str],
                 tolerance: int = 0):
        self.left_on = left_on
        self.left_by = list(left_by)
        self.right_on = right_on
        self.right_by = list(right_by)
        self.tolerance = int(tolerance)


class SortedMergeNodeOptions(ExecNodeOptions):
    """A merge of inputs each sorted by ``sort_keys``."""

    def __init__(self, sort_keys, null_placement: str = "at_end"):
        self.sort_keys = _sort_keys(sort_keys)
        self.null_placement = null_placement


class SinkNodeOptions(ExecNodeOptions):
    """A terminal that passes its input through: results come out of
    ``Declaration.to_table()``."""

    def __init__(self, schema=None, backpressure=None):
        self.schema = schema
        self.backpressure = backpressure


class TableSinkNodeOptions(SinkNodeOptions):
    pass


class OrderBySinkNodeOptions(SinkNodeOptions):
    def __init__(self, sort_keys, null_placement: str = "at_end",
                 schema=None):
        super().__init__(schema)
        self.sort_keys = _sort_keys(sort_keys)
        self.null_placement = null_placement


class SelectKSinkNodeOptions(SinkNodeOptions):
    """The first ``k`` rows in ``sort_keys`` order."""

    def __init__(self, k: int, sort_keys, schema=None):
        super().__init__(schema)
        self.k = int(k)
        self.sort_keys = _sort_keys(sort_keys)
