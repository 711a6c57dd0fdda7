"""DataVec — the ETL layer (the port of ``deeplearning4j_tpu/datavec``,
SURVEY.md §2.4): RecordReaders, Writables, Schema / TransformProcess with
their JSON, joins and reductions, the image pipeline (on the port's own
PNG codec), the iterator glue, and the sharded producer pool with its
pinned H2D staging ring onto the card.  Host work is numpy and the port's
build of the C++ runtime (:mod:`deeplearning4j_tpu_torch.native`).

The format readers ``audio``, ``codec``, ``arrow``, ``excel`` and
``columnar`` wait for ROADMAP "A12 datavec formats": their names import
from their modules and raise naming it.
"""
from deeplearning4j_tpu_torch.datavec.writable import (  # noqa: F401
    BooleanWritable, DoubleWritable, FloatWritable, IntWritable, LongWritable,
    NDArrayWritable, NullWritable, Text, Writable, writable)
from deeplearning4j_tpu_torch.datavec.records import (  # noqa: F401
    CollectionRecordReader, CollectionSequenceRecordReader, CSVRecordReader,
    CSVSequenceRecordReader, FileSplit, InputSplit, LineRecordReader,
    NumberedFileInputSplit, RecordReader, RegexLineRecordReader,
    SequenceRecordReader, StringSplit, SVMLightRecordReader)
from deeplearning4j_tpu_torch.datavec.schema import (  # noqa: F401
    ColumnMetaData, ColumnType, Schema, SequenceSchema)
from deeplearning4j_tpu_torch.datavec.transform import (  # noqa: F401
    CategoricalColumnCondition, ColumnCondition, ConditionFilter, ConditionOp,
    DoubleColumnCondition, IntegerColumnCondition, LocalTransformExecutor,
    NumericalColumnComparator, SparkTransformExecutor, StringColumnCondition,
    TransformProcess)
from deeplearning4j_tpu_torch.datavec.join import Join, JoinType  # noqa: F401
from deeplearning4j_tpu_torch.datavec.reduce import ReduceOp, Reducer  # noqa: F401
from deeplearning4j_tpu_torch.datavec.image import (  # noqa: F401
    ColorConversionTransform, CropImageTransform, FlipImageTransform,
    ImageRecordReader, ImageTransform, NativeImageLoader,
    ParentPathLabelGenerator, PipelineImageTransform, RotateImageTransform,
    ScaleImageTransform)
from deeplearning4j_tpu_torch.datavec.audio import (  # noqa: F401
    AudioFeatureRecordReader, WavFileRecordReader, mfcc, read_wav,
    spectrogram)
from deeplearning4j_tpu_torch.datavec.codec import CodecRecordReader  # noqa: F401
from deeplearning4j_tpu_torch.datavec.arrow import (  # noqa: F401
    ArrowConverter, ArrowRecordReader)
from deeplearning4j_tpu_torch.datavec.excel import (  # noqa: F401
    ExcelRecordReader, writeXlsx)
from deeplearning4j_tpu_torch.datavec.columnar import (  # noqa: F401
    ColumnarConverter, JDBCRecordReader)
from deeplearning4j_tpu_torch.datavec.iterators import (  # noqa: F401
    AsyncDataSetIterator, RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator)
from deeplearning4j_tpu_torch.datavec.pipeline import (  # noqa: F401
    PrefetchingDataSetIterator, ProducerWorkerError, ShardSpec,
    maybe_prefetch)
